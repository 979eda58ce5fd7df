// K-umuf: one fused Farneback iteration at one pyramid level.
//
// Replaces the Pallas TPU kernel flowdenoising_tpu/ops/pallas/umuf.py:
// _umuf_kernel -> _phase1_phase2 (reached through umuf_iterate_prepped).
// The plain PyTorch version is flowdenoising_tpu_torch/ops/farneback.py:
// update_flow_plain(update_matrices_plain(r0, r1, flow, d), winsize).
//
// Phase 1 (per pixel, farneback.cuh: matrices_at): sample the five
// channels of the reference expansion r1 bilinearly at (x + u, y + v), u
// and v clamped to +-d (no clamp when `clamp` is 0), replicate borders;
// mask out-of-plane samples using the UNCLAMPED flow; average the
// quadratic terms with r0; add the flow terms with the unclamped flow;
// scale by the 5-px border ramp; form M = [G11, G12, G22, h1, h2].
// Phase 2 (per pixel, farneback.cuh: box_solve_tile): box-sum M over
// (2r+1)^2, r = winsize/2, with borders replicating the true edge M; scale
// by 1/winsize^2; solve the 2x2 system regularised by +1e-3.
//
// What bounds it on the H100: per pixel, ~25 dependent gathered loads in
// phase 1 and 5*(2r+1)^2 adds in phase 2, with no matrix product anywhere --
// far below the tensor-core line.  It is bound by load latency and memory
// traffic.  The TPU kernel's answer was to keep M in VMEM across a whole
// row tile; here a block keeps its tile's M in shared memory:
// - each block owns a TILE_Y x TILE_X output tile and computes M for the
//   tile plus a halo of r on every side into shared memory
//   (5 * (16+2r) * (32+2r) floats: 14.4 KB at winsize 5), so M never goes
//   to device memory;
// - a halo pixel outside the plane computes M AT THE CLAMPED PLANE
//   COORDINATE, which is exactly "replicate the true edge M"
//   (flowdenoising_tpu/ops/pallas/umuf.py:14-26); M is never computed from
//   padded inputs;
// - the box sum reads shared memory only, columns of the window in the same
//   order as the plain separable sum (rows first, then columns);
// - one launch per iteration, ping-ponging two flow buffers: the next
//   iteration's phase 1 reads the neighbours' updated flow.
// The halo costs (16+2r)(32+2r)/512 = 1.4x phase-1 work at winsize 5.
// Built with -fmad=false so the arithmetic rounds as the plain version's
// separate multiplies and adds do.

#include "farneback.cuh"

namespace {

__global__ void umuf_kernel(const float* __restrict__ r0,
                            const float* __restrict__ r1,
                            const float* __restrict__ flow_in,
                            float* __restrict__ flow_out,
                            int H, int W, float d, int clamp, int r,
                            float inv_ws2) {
  extern __shared__ float m_s[];
  const int sw = TILE_X + 2 * r;
  const int plane = sw * (TILE_Y + 2 * r);
  const long long hw = (long long)H * W;
  const long long b = blockIdx.z;
  const float* R0 = r0 + b * 5 * hw;
  const float* R1 = r1 + b * 5 * hw;
  const float* U = flow_in + b * 2 * hw;
  const float* V = U + hw;
  const int tx0 = blockIdx.x * TILE_X;
  const int ty0 = blockIdx.y * TILE_Y;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;

  // ---- phase 1: M for the tile plus halo, into shared memory ----
  for (int idx = tid; idx < plane; idx += BLOCK_X * BLOCK_Y) {
    const int ly = idx / sw;
    const int lx = idx - ly * sw;
    const int y = min(max(ty0 - r + ly, 0), H - 1);
    const int x = min(max(tx0 - r + lx, 0), W - 1);
    float m[5];
    matrices_at(R0, R1, U, V, x, y, H, W, hw, d, clamp, m);
#pragma unroll
    for (int c = 0; c < 5; ++c) m_s[c * plane + idx] = m[c];
  }
  __syncthreads();

  // ---- phase 2: box sum over the window, 2x2 solve ----
  float* out = flow_out + b * 2 * hw;
  box_solve_tile(m_s, tx0, ty0, H, W, r, inv_ws2, out, out + hw);
}

}  // namespace

// One iteration.  r0, r1: (B, 5, H, W); flow_in, flow_out: (B, 2, H, W);
// all contiguous float32, flow_out distinct from flow_in.  inv_ws2 is
// 1/winsize^2 rounded to float32.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fdt_umuf_step(const float* r0, const float* r1,
                             const float* flow_in, float* flow_out,
                             int B, int H, int W, float d, int clamp,
                             int winsize, float inv_ws2, void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  const int r = winsize / 2;
  const size_t smem = tile_smem_bytes(r);
  const cudaError_t e = allow_smem(umuf_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TILE_X - 1) / TILE_X, (H + TILE_Y - 1) / TILE_Y, B);
  const dim3 block(BLOCK_X, BLOCK_Y);
  umuf_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      r0, r1, flow_in, flow_out, H, W, d, clamp, r, inv_ws2);
  return (int)cudaGetLastError();
}
