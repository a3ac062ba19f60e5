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

// library_walk: fused multi-function evaluation over uniform (v1) and
// segmented (v2) slots in one launch.
//
// Replaces repro/kernels/interp/kernel.py `library_walk_2d` /
// `_library_walk_kernel` (l.336): element i reads the walk row (in_bits,
// depth, seg_flag, leaf_base, n_leaves) of fids[i]. A uniform slot's
// datapath row is dp[leaf_base] and its region the top bits of the code; a
// segmented slot resolves cell = code >> (in_bits - depth) to a leaf through
// its packed segment-index table (entry (fid * r_max + n_leaves) * 3 + cell
// of the flat ROM), then reads ROM row fid * r_max + leaf and datapath row
// dp[leaf_base + leaf]. Both go through `lut_rom` of datapath.cuh, the read
// every fused kernel inlines.
//
// Bound on an H100: bytes, as library_eval (a 4-byte code, a 4-byte id
// unless one id serves every element, a 4-byte result; a dependent shared
// load or two and a handful of integer operations per element). Design: the
// ROM (4 KiB at (8, 42, 3)) and the leaf datapath rows (1.7 KiB for 86
// leaves) are staged once per block in shared memory, and each block turns
// the walk rows into one `TableArgs` per function there, once; a
// grid-stride loop then streams the elements through `lut_rom`. A malformed
// walk row (a base or leaf count past the dp rows, a segment table that does
// not fit the slot or a depth the shifts cannot take) becomes an empty slot,
// which reads 0 as an out-of-range region does.
__global__ void library_walk_kernel(const int32_t* __restrict__ codes,
                                    const int32_t* __restrict__ fids,
                                    int fid0,
                                    const int32_t* __restrict__ rom,
                                    const int32_t* __restrict__ walk,
                                    const int32_t* __restrict__ dp,
                                    int n_funcs, int r_max, int n_dp,
                                    int32_t* __restrict__ out, int64_t n) {
  extern __shared__ __align__(8) unsigned char walk_smem[];
  TableArgs* s_args = reinterpret_cast<TableArgs*>(walk_smem);
  int32_t* s_rom = reinterpret_cast<int32_t*>(s_args + n_funcs);
  int32_t* s_dp = s_rom + n_funcs * r_max * 3;
  for (int i = threadIdx.x; i < n_funcs * r_max * 3; i += blockDim.x)
    s_rom[i] = rom[i];
  for (int i = threadIdx.x; i < 5 * n_dp; i += blockDim.x) s_dp[i] = dp[i];
  for (int f = threadIdx.x; f < n_funcs; f += blockDim.x) {
    const int32_t* w = walk + 5 * f;  // in_bits, depth, seg_flag, base, n
    const int base = w[3], n_rows = w[2] ? w[4] : 1;
    TableArgs t{f * r_max, r_max, 0, 0, 0, 0, 0, w[0], 0, 0, 0, nullptr};
    bool ok = base >= 0 && n_rows > 0 && base + n_rows <= n_dp;
    if (ok && w[2]) {
      t.seg_depth = w[1];
      t.n_leaves = w[4];
      t.leaf_dp = s_dp + 5 * base;
      ok = table_args_ok(t);
    } else if (ok) {  // read from global: s_dp is not synchronized yet
      const int32_t* m = dp + 5 * base;
      t.eval_bits = m[0];
      t.k = m[1];
      t.sq_trunc = m[2];
      t.lin_trunc = m[3];
      t.degree = m[4];
    }
    if (!ok) t = TableArgs{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, nullptr};
    s_args[f] = t;
  }
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const int f = fids ? fids[i] : fid0;
    out[i] = (unsigned)f < (unsigned)n_funcs
                 ? lut_rom(s_rom, s_args[f], codes[i])
                 : 0;
  }
}

// fids: one id per element, or null to evaluate function fid0 everywhere.
extern "C" int repro_library_walk(const int32_t* codes, const int32_t* fids,
                                  int fid0, const int32_t* rom,
                                  const int32_t* walk, const int32_t* dp,
                                  int n_funcs, int r_max, int n_dp,
                                  int32_t* out, int64_t n, int device,
                                  void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const size_t smem = (size_t)n_funcs * sizeof(TableArgs) +
                      (size_t)(n_funcs * r_max * 3 + 5 * n_dp) * 4;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(library_walk_kernel,
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
  library_walk_kernel<<<(int)blocks, threads, smem, (cudaStream_t)stream>>>(
      codes, fids, fid0, rom, walk, dp, n_funcs, r_max, n_dp, out, n);
  return (int)cudaGetLastError();
}

// rom_eval: one slot of a flat library ROM through `lut_rom`.
//
// Replaces repro/kernels/interp/kernel.py `rom_eval_2d` / `_rom_kernel`
// (l.175), the golden harness of the in-kernel read: one function of the
// (F * r_max, 3) ROM, uniform or segmented, through exactly the `lut_rom`
// that softmax_lib, rmsnorm_lib and flash_attn_lib inline. Bound on an
// H100: bytes (a 4-byte code in, a 4-byte result out). Design: the slot and
// a segmented slot's leaf rows are staged in shared memory (`stage_slot`,
// as the fused kernels stage them); a slot too large for shared memory is
// refused at launch. A grid-stride loop takes any code count.
__global__ void rom_eval_kernel(const int32_t* __restrict__ codes,
                                const int32_t* __restrict__ rom, TableArgs t,
                                int32_t* __restrict__ out, int64_t n) {
  extern __shared__ int32_t smem[];
  stage_slot(rom, t, smem);
  __syncthreads();
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step)
    out[i] = lut_rom(smem, t, codes[i]);
}

// slot12: see datapath.cuh `table_args`; dp: the library's leaf rows.
extern "C" int repro_rom_eval(const int32_t* codes, const int32_t* rom,
                              const int32_t* slot12, const int32_t* dp,
                              int32_t* out, int64_t n, int device,
                              void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const TableArgs t = table_args(slot12, dp);
  if (!table_args_ok(t)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const size_t smem = (size_t)slot_words(t) * 4;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rom_eval_kernel,
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
  rom_eval_kernel<<<(int)blocks, threads, smem, (cudaStream_t)stream>>>(
      codes, rom, t, out, n);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
