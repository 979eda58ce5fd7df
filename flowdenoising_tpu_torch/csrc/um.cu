// K-um: phase 1 of a Farneback iteration on its own -- the per-pixel
// normal-equation entries M = [G11, G12, G22, h1, h2], written to device
// memory.
//
// Replaces the Pallas TPU kernel flowdenoising_tpu/ops/pallas/
// update_matrices.py: _um_kernel (reached through update_matrices_pallas).
// The plain PyTorch version is flowdenoising_tpu_torch/ops/farneback.py:
// update_matrices_plain.  The port's solver runs both phases fused in
// K-umuf; this kernel serves the split iteration that the -v 2 stage report
// times, as the JAX package's does.
//
// Per pixel (farneback.cuh: matrices_at, K-umuf's arithmetic too): sample the
// five channels of r1 bilinearly at (x + u, y + v), u and v clamped to +-d
// (no clamp when `clamp` is 0), replicate borders; mask with the in-plane
// test on the UNCLAMPED flow; average the quadratic terms and add the flow
// terms with the unclamped flow; apply the 5-px border ramp on plane
// coordinates; write the five products.
//
// What bounds it on the H100: it must read r0 and r1 (5 channels each) and
// the flow (2) once and write M (5): 68 B per pixel, ~70 flops -- bound by
// bytes (1.14 GB, 0.341 ms at (256, 5, 256, 256) and 3.35 TB/s).  The
// design is the simple one: one thread per pixel, neighbouring threads on
// neighbouring x so every plane access of a warp is one or two cache lines;
// the four bilinear texels per channel go through the read-only cache,
// where the overlapping footprints of neighbouring pixels hit.  The TPU
// kernel's row tiles with context rows, two-window lane gathers, shift-loop
// skipping and bf16 pairs answer the TPU's missing per-lane gather and are
// not carried over.  Built with -fmad=false so the arithmetic rounds as the
// plain version's separate multiplies and adds do.
//
// The packed form (K-um-bf16, the TPU kernel's `packed` r1,
// update_matrices.py:114) reads r1 as bfloat16 (T1 = __nv_bfloat16,
// bf16.cuh): 58 B per pixel instead of 68.  The -v 2 reconstruction runs it
// when the precision is bfloat16, as the JAX package's stage report does.

#include "farneback.cuh"

namespace {

template <typename T1>
__global__ void um_kernel(const float* __restrict__ r0,
                          const T1* __restrict__ r1,
                          const float* __restrict__ flow,
                          float* __restrict__ m_out,
                          int H, int W, float d, int clamp) {
  const int x = blockIdx.x * BLOCK_X + threadIdx.x;
  const int y = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long hw = (long long)H * W;
  const long long b = blockIdx.z;
  const float* U = flow + b * 2 * hw;
  float m[5];
  matrices_at(r0 + b * 5 * hw, r1 + b * 5 * hw, U, U + hw, x, y, H, W, hw,
              d, clamp, 0, m);
  float* M = m_out + b * 5 * hw + (long long)y * W + x;
#pragma unroll
  for (int c = 0; c < 5; ++c) M[c * hw] = m[c];
}

template <typename T1>
int launch_um(const float* r0, const T1* r1, const float* flow, float* m,
              int B, int H, int W, float d, int clamp, void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  const dim3 grid((W + BLOCK_X - 1) / BLOCK_X, (H + BLOCK_Y - 1) / BLOCK_Y, B);
  const dim3 block(BLOCK_X, BLOCK_Y);
  um_kernel<T1><<<grid, block, 0, (cudaStream_t)stream>>>(r0, r1, flow, m, H,
                                                           W, d, clamp);
  return (int)cudaGetLastError();
}

}  // namespace

// r0, r1, m: (B, 5, H, W); flow: (B, 2, H, W), channel 0 = x; all
// contiguous float32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int fdt_update_matrices(const float* r0, const float* r1,
                                   const float* flow, float* m, int B, int H,
                                   int W, float d, int clamp, void* stream) {
  return launch_um(r0, r1, flow, m, B, H, W, d, clamp, stream);
}

// The packed form: fdt_update_matrices with r1 contiguous bfloat16.
extern "C" int fdt_update_matrices_bf16(const float* r0,
                                        const __nv_bfloat16* r1,
                                        const float* flow, float* m, int B,
                                        int H, int W, float d, int clamp,
                                        void* stream) {
  return launch_um(r0, r1, flow, m, B, H, W, d, clamp, stream);
}
