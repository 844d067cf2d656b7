// Building blocks shared by the instance-norm kernels of this directory
// (instance_norm_fwd.cu: the forward; instance_norm_bwd.cu: the backward):
// their block shape, f32 conversions of an element, VEC elements as one
// 16-byte vector, and the device queries that size their grids. The W8A8
// activation quantize (quant_act.cu) uses the conversions and the device
// attribute query, the pad kernels (pad_nhwc.cu) the conversions.
//
// Each source that includes this file is built into a shared library of
// its own (ops/_build.py hashes every *.cuh into each library's name).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace inorm {

// threads per block, and channels per group of (sample, 64 channels): a
// thread owns VEC channels of a pixel row (ops/instance_norm.py keeps the
// same two numbers as _NORM_THREADS and _NORM_CHANNELS)
constexpr int THREADS = 256;
constexpr int CB = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// VEC elements of T as one value: a 16-byte vector where VEC fills one,
// else (VEC = 1) the element.
template <typename T, int VEC>
using Raw = typename std::conditional<VEC * sizeof(T) == 16, uint4, T>::type;

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const Raw<T, VEC>& r,
                                       float (&v)[VEC]) {
  static_assert(VEC == 1 || VEC * sizeof(T) == 16, "a vector or an element");
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ Raw<T, VEC> pack(const float (&v)[VEC]) {
  Raw<T, VEC> r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < VEC; ++i) from_f32(e + i, v[i]);
  return r;
}

// VEC elements at p into f32, and f32 into VEC elements at p: one access.
// The load goes into a register first: unpacking straight from the
// pointer lets the compiler read each element from memory on its own.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  const Raw<T, VEC> r = *reinterpret_cast<const Raw<T, VEC>*>(p);
  unpack<T, VEC>(r, v);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  *reinterpret_cast<Raw<T, VEC>*>(p) = pack<T, VEC>(v);
}

// Attribute a of the current device into *v.
inline cudaError_t device_attribute(cudaDeviceAttr a, int* v) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err == cudaSuccess ? cudaDeviceGetAttribute(v, a, dev) : err;
}

// How many blocks of kernel fn, with smem bytes of dynamic shared memory
// each, the current device holds at once: its occupancy per SM x the SM
// count, into *blocks. The most a cooperative launch of fn may have.
inline cudaError_t co_resident_blocks(const void* fn, size_t smem,
                                      int* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err = device_attribute(cudaDevAttrMultiProcessorCount, &sms);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                        smem);
  if (err == cudaSuccess) *blocks = per_sm * sms;
  return err;
}

}  // namespace inorm
