// Helpers shared by the kernels of davo_tpu_torch/csrc: asynchronous
// copies into shared memory, split-TF32 operands and products on the
// tensor cores, and the limits of the current device.
// Each source includes this header; kernels/cuda_build.py rebuilds every
// source when it changes.

#pragma once

#include <cuda_runtime.h>

namespace davo {

constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async global -> shared: no register is held while the copy is in
// flight. 4 and 8 bytes go through L1 (.ca), 16 bytes through L2 only
// (.cg); both addresses are aligned to the size. With `valid` false the
// copy reads nothing and writes zeros.
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void copy_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Split TF32 (CUTLASS's 3xTF32): a float32 operand is v = hi + lo with
// hi = tf32_rna(v) and lo = tf32_rna(v - hi), and a product is
// lo_a hi_b + hi_a lo_b + hi_a hi_b, which leaves ~2^-22 of it (lo*lo
// dropped), against 2^-11 for one TF32 pass. A value TF32 holds exactly
// (bf16) needs no lo.
__device__ __forceinline__ unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32 values (the low 13 mantissa bits zero).
__device__ __forceinline__ void split(float v, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// c += a (16x8, row) * b (8x8, col), TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b, the accumulator starting at zero.
__device__ __forceinline__ void mma_tf32_fresh(float d[4], const unsigned a[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

// The current device, refused (cudaErrorInvalidDevice) at kMaxDevices or
// above, where the per-device tables below end.
inline cudaError_t current_device(int* device) {
  const cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  return *device < kMaxDevices ? cudaSuccess : cudaErrorInvalidDevice;
}

// The largest dynamic shared memory a block of `device` may opt in to,
// and its number of SMs; asked once per device.
inline cudaError_t device_limits(int device, int* smem_bytes, int* sms) {
  static int smem[kMaxDevices] = {}, count[kMaxDevices] = {};
  if (smem[device] == 0) {
    cudaError_t err =
        cudaDeviceGetAttribute(&smem[device], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&count[device], cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) {
      smem[device] = 0;
      return err;
    }
  }
  *smem_bytes = smem[device];
  *sms = count[device];
  return cudaSuccess;
}

// Raises `kernel`'s dynamic shared-memory limit on `device` to `bytes`
// where it is lower; `granted` is the caller's table for that one kernel
// (a static per kernel), so the attribute is set once per kernel, device
// and size, not on every launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int device, size_t bytes, int (&granted)[kMaxDevices]) {
  if (bytes <= 48 * 1024 || granted[device] >= static_cast<int>(bytes)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) granted[device] = static_cast<int>(bytes);
  return err;
}

}  // namespace davo
