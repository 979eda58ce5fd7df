// The bfloat16 side of the kernels' packed forms (--precision bfloat16),
// shared by K-umuf, K-um (farneback.cuh) and K-compose (compose.cu).
//
// A packed form reads its sampling source as bfloat16 through the
// read-only path and widens each texel exactly to float32; everything after
// the load is the float32 form's arithmetic.  This is what the TPU kernels'
// bf16 pair packing (flowdenoising_tpu/ops/pallas/sample.py: pack_pairs)
// computes: the source rounded to bfloat16 (round to nearest even),
// interpolated in float32.  The pairs themselves answer the TPU's lane
// gather and are not carried over.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// x rounded to bfloat16 (to nearest even) and widened back: the value a
// bf16 pass carries where it stores x.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

}  // namespace
