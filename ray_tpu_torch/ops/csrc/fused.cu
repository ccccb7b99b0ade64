// RMSNorm for Hopper (sm_90a): one CUDA kernel, rmsnorm_kernel.
//
// Replaces the Pallas TPU kernel _rmsnorm_kernel of ray_tpu/ops/fused.py
// (launched by _rmsnorm_fwd_impl): out = x * rsqrt(mean(x^2) + eps) * scale
// over the last axis of x [rows, D], with f32 statistics and one rounding
// to x's dtype on the store.
//
// What bounds it on an H100: it does about 4 operations per element and
// must move each element twice (read x, write out), so it is bound by
// memory bandwidth at large row counts and by launch latency at the decode
// shape ([8, 4096] moves 131 KB, 0.04 us at 3.35 TB/s). The design reads x
// from device memory once: one block owns one row, reads it with 16-byte
// vector loads while summing squares in f32, reduces with warp shuffles and
// one word of shared memory per warp, then reads the row again (from L1 or
// L2, where the first pass left it) to scale and store. The TPU kernel's
// row tiling (block_rows halved to fit VMEM) has no counterpart: a block
// holds no more than its registers.
//
// x is [rows, D] with a contiguous last dim and any row stride; out is
// [rows, D], contiguous. Vector loads need x's rows 16-byte aligned and
// vector stores need out's rows so; where a row is not, or past the last
// whole vector of a row, the kernel takes one element at a time. scale is
// [D], contiguous, f32 or bf16, upcast to f32. x and out are f32 or bf16.
//
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError(). At the decode
// shape the launch path, not the kernel, sets the time of a call: the
// entry point takes the launch's scalars as one packed block (RmsArgs),
// since a caller through ctypes pays for each argument it converts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_THREADS = 1024;
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

// One block per row; blockDim.x is a multiple of 32.
template <typename T, typename S>
__global__ void rmsnorm_kernel(const T* __restrict__ x, long long x_row_stride,
                               const S* __restrict__ scale,
                               T* __restrict__ out, int d, float eps,
                               int vec_loads, int vec_stores) {
  constexpr int VEC = 16 / sizeof(T);
  const T* row = x + (long long)blockIdx.x * x_row_stride;
  T* out_row = out + (long long)blockIdx.x * d;
  const int nvec = vec_loads ? d / VEC : 0;
  const int tail = nvec * VEC;

  float sum_sq = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(row)[i];
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f32(vals[j]);
      sum_sq += f * f;
    }
  }
  for (int i = tail + threadIdx.x; i < d; i += blockDim.x) {
    const float f = to_f32(row[i]);
    sum_sq += f * f;
  }

  __shared__ float warp_sums[MAX_THREADS / 32];
  __shared__ float inv_rms;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  sum_sq = warp_sum(sum_sq);
  if (lane == 0) warp_sums[warp] = sum_sq;
  __syncthreads();
  if (warp == 0) {
    float total = lane < (int)(blockDim.x / 32) ? warp_sums[lane] : 0.f;
    total = warp_sum(total);
    if (lane == 0) inv_rms = rsqrtf(total / (float)d + eps);
  }
  __syncthreads();
  const float inv = inv_rms;

  // (x * inv) * scale, in that order, as the plain version computes it.
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(row)[i];
    const T* vals = reinterpret_cast<const T*>(&raw);
    uint4 packed;
    T* res = reinterpret_cast<T*>(&packed);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      res[j] = from_f32<T>(to_f32(vals[j]) * inv * to_f32(scale[i * VEC + j]));
    if (vec_stores) {
      reinterpret_cast<uint4*>(out_row)[i] = packed;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) out_row[i * VEC + j] = res[j];
    }
  }
  for (int i = tail + threadIdx.x; i < d; i += blockDim.x)
    out_row[i] = from_f32<T>(to_f32(row[i]) * inv * to_f32(scale[i]));
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, long long x_row_stride, float eps,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec_loads =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      (rows == 1 || (x_row_stride * (long long)sizeof(T)) % 16 == 0);
  const bool vec_stores = reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                          ((long long)d * sizeof(T)) % 16 == 0;
  const int work = vec_loads ? (d + VEC - 1) / VEC : d;
  int threads = (work + 31) / 32 * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  rmsnorm_kernel<T, S><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), x_row_stride, static_cast<const S*>(scale),
      static_cast<T*>(out), d, eps, vec_loads, vec_stores);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rtt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch's scalars, in the layout of Python's struct format "@iiiiqf"
// (ops/fused.py, _RMS_ARGS). A field out of order gives wrong rows, not a
// crash: the card tests and chip_smoke.py's rmsnorm phase cover every
// dtype pair and row stride against the plain version.
// x and out: dtype code x_dtype (0 f32, 1 bf16); scale: scale_dtype.
struct RmsArgs {
  int x_dtype, scale_dtype, rows, d;
  long long x_row_stride;
  float eps;
};

int rtt_rmsnorm(const void* x, const void* scale, void* out,
                const RmsArgs* a, void* stream) {
  const int rows = a->rows, d = a->d;
  const long long stride = a->x_row_stride;
  const float eps = a->eps;
  if (rows < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->x_dtype == DTYPE_BF16 && a->scale_dtype == DTYPE_BF16)
    return (int)launch<bf16, bf16>(x, scale, out, rows, d, stride, eps, s);
  if (a->x_dtype == DTYPE_BF16 && a->scale_dtype == DTYPE_F32)
    return (int)launch<bf16, float>(x, scale, out, rows, d, stride, eps, s);
  if (a->x_dtype == DTYPE_F32 && a->scale_dtype == DTYPE_BF16)
    return (int)launch<float, bf16>(x, scale, out, rows, d, stride, eps, s);
  if (a->x_dtype == DTYPE_F32 && a->scale_dtype == DTYPE_F32)
    return (int)launch<float, float>(x, scale, out, rows, d, stride, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
