// K-uf: phase 2 of a Farneback iteration on its own -- box-aggregate M and
// solve the per-pixel 2x2 systems for the flow.
//
// Replaces the Pallas TPU kernel flowdenoising_tpu/ops/pallas/
// update_flow.py: _uf_kernel (reached through update_flow_pallas).  The
// plain PyTorch version is flowdenoising_tpu_torch/ops/farneback.py:
// update_flow_plain.  The port's solvers run both phases fused: K-umuf with
// a bound or in float32, K-umuf-split (umuf_split.cu) in the bf16 pass with
// no bound, where the JAX package's TPU path runs this kernel after a phase
// 1 in XLA.  This kernel is B5's counterpart on its own, off the denoise
// paths: the -v 2 stage report's reconstruction times it.
//
// M (B, 5, H, W) -> flow (B, 2, H, W): the replicate-border box sum of each
// channel over (2r+1)^2, r = winsize/2, times float32(1/winsize^2)
// (OpenCV's scale, also for an even winsize), then idet = 1/(g11*g22 -
// g12^2 + 1e-3), u = (g11*h2 - g12*h1)*idet, v = (g22*h1 - g12*h2)*idet.
//
// What bounds it on the H100: it must read M (5 channels) once and write
// the flow (2): 28 B per pixel, and a separable box sum needs 5*2*(2r+1)
// adds -- bound by bytes at every winsize (470 MB, 0.140 ms at (256, 5,
// 256, 256) and 3.35 TB/s).  Each block loads its TILE_Y x TILE_X tile of
// M plus a halo of r on every side into shared memory, border indices
// clamped on the load (replicate), then runs K-umuf's phase 2
// (farneback.cuh: box_solve_tile -> box_solve): the separable sum, first
// the 2r+1 rows of each window (one thread per channel and tile column;
// for r <= 7 the column's window rows kept in registers), then 2r+1 of
// those row sums (one thread per output pixel), each in ascending tap
// order as the plain separable sum adds them and afresh for every pixel,
// so with -fmad=false the result equals the plain version's.  That is
// 2*(2r+1) shared loads per pixel and channel where summing each window
// whole took (2r+1)^2; what is left above the bytes bound is the tile's
// load and the row pass, one column a thread, down the tile.  The TPU
// kernel's pre-padded row tiles and lane-padded VMEM buffers answer TPU
// layout limits and are not carried over.

#include "farneback.cuh"

namespace {

__global__ void uf_kernel(const float* __restrict__ m,
                          float* __restrict__ flow, int H, int W, int r,
                          float inv_ws2) {
  extern __shared__ float m_s[];
  const int sw = TILE_X + 2 * r;
  const int plane = sw * (TILE_Y + 2 * r);
  const long long hw = (long long)H * W;
  const long long b = blockIdx.z;
  const float* M = m + b * 5 * hw;
  const int tx0 = blockIdx.x * TILE_X;
  const int ty0 = blockIdx.y * TILE_Y;
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;

  for (int idx = tid; idx < plane; idx += BLOCK_X * BLOCK_Y) {
    const int ly = idx / sw;
    const int lx = idx - ly * sw;
    const int y = min(max(ty0 - r + ly, 0), H - 1);
    const int x = min(max(tx0 - r + lx, 0), W - 1);
    const long long p = (long long)y * W + x;
#pragma unroll
    for (int c = 0; c < 5; ++c) m_s[c * plane + idx] = __ldg(M + c * hw + p);
  }
  __syncthreads();

  float* out = flow + b * 2 * hw;
  box_solve_tile(m_s, tx0, ty0, H, W, r, inv_ws2, out, out + hw);
}

}  // namespace

// Shared memory a block's tile takes at `winsize`; the wrapper refuses a
// winsize whose tile exceeds the H100's 227 KB a block.
extern "C" long long fdt_update_flow_smem(int winsize) {
  return (long long)tile_smem_bytes(winsize / 2);
}

// m: (B, 5, H, W); flow: (B, 2, H, W); contiguous float32.  inv_ws2 is
// 1/winsize^2 rounded to float32.  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int fdt_update_flow(const float* m, float* flow, int B, int H,
                               int W, int winsize, float inv_ws2,
                               void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  const int r = winsize / 2;
  const size_t smem = tile_smem_bytes(r);
  const cudaError_t e = allow_smem(uf_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TILE_X - 1) / TILE_X, (H + TILE_Y - 1) / TILE_Y, B);
  const dim3 block(BLOCK_X, BLOCK_Y);
  uf_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(m, flow, H, W, r,
                                                         inv_ws2);
  return (int)cudaGetLastError();
}
