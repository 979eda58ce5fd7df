// K-umuf: one fused Farneback iteration at one pyramid level.
//
// Replaces the Pallas TPU kernel flowdenoising_tpu/ops/pallas/umuf.py:
// _umuf_kernel -> _phase1_phase2 (reached through umuf_iterate_prepped).
// The plain PyTorch version is flowdenoising_tpu_torch/ops/farneback.py:
// update_flow(update_matrices(r0, r1, flow, d), winsize).
//
// Phase 1 (per pixel): sample the five channels of the reference expansion
// r1 bilinearly at (x + u, y + v), u and v clamped to +-d (no clamp when
// `clamp` is 0), replicate borders; mask out-of-plane samples using the
// UNCLAMPED flow; average the quadratic terms with r0; add r4*dy + r6*dx and
// r6*dy + r5*dx with the unclamped flow; scale by the 5-px border ramp;
// form M = [G11, G12, G22, h1, h2].
// Phase 2 (per pixel): box-sum M over (2r+1)^2, r = winsize/2, with borders
// replicating the true edge M; scale by 1/winsize^2 (not 1/(2r+1)^2: they
// differ for an even winsize); solve the 2x2 system regularised by +1e-3.
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

#include <cuda_runtime.h>

namespace {

constexpr int TILE_X = 32;
constexpr int TILE_Y = 16;
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

__constant__ double kRamp[5] = {0.14, 0.14, 0.4472, 0.4472, 0.4472};

// Border down-weighting along one axis, as the float64 host map of
// ops/farneback.py: _border_scale_map (both bands multiply where they
// overlap on planes narrower than 10 px).
__device__ __forceinline__ double edge_weight(int i, int n) {
  double s = 1.0;
  if (i < 5) s *= kRamp[i];
  const int j = n - 1 - i;
  if (j < 5) s *= kRamp[j];
  return s;
}

__global__ void umuf_kernel(const float* __restrict__ r0,
                            const float* __restrict__ r1,
                            const float* __restrict__ flow_in,
                            float* __restrict__ flow_out,
                            int H, int W, float d, int clamp, int r,
                            float inv_ws2) {
  extern __shared__ float m_s[];
  const int sw = TILE_X + 2 * r;
  const int sh = TILE_Y + 2 * r;
  const int plane = sw * sh;
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
    const long long p = (long long)y * W + x;

    const float dx = U[p];
    const float dy = V[p];
    const float fx1 = floorf((float)x + dx);
    const float fy1 = floorf((float)y + dy);
    const bool inb = fx1 >= 0.0f && fx1 <= (float)(W - 2) &&
                     fy1 >= 0.0f && fy1 <= (float)(H - 2);

    float su = dx, sv = dy;
    if (clamp) {
      su = fminf(fmaxf(su, -d), d);
      sv = fminf(fmaxf(sv, -d), d);
    }
    const float fx = (float)x + su;
    const float fy = (float)y + sv;
    float x0f = floorf(fx);
    float y0f = floorf(fy);
    const float tx = fx - x0f;
    const float ty = fy - y0f;
    x0f = fminf(fmaxf(x0f, -1.0f), (float)W);
    y0f = fminf(fmaxf(y0f, -1.0f), (float)H);
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const int xa = min(max(x0, 0), W - 1);
    const int xb = min(max(x0 + 1, 0), W - 1);
    const long long ra = (long long)min(max(y0, 0), H - 1) * W;
    const long long rb = (long long)min(max(y0 + 1, 0), H - 1) * W;

    float s[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float* q = R1 + c * hw;
      const float v00 = __ldg(q + ra + xa);
      const float v01 = __ldg(q + ra + xb);
      const float v10 = __ldg(q + rb + xa);
      const float v11 = __ldg(q + rb + xb);
      const float top = v00 + (v01 - v00) * tx;
      const float bot = v10 + (v11 - v10) * tx;
      s[c] = top + (bot - top) * ty;
    }
    const float a0 = R0[p], a1 = R0[hw + p], a2 = R0[2 * hw + p];
    const float a3 = R0[3 * hw + p], a4 = R0[4 * hw + p];

    float r4 = inb ? (a2 + s[2]) * 0.5f : a2;
    float r5 = inb ? (a3 + s[3]) * 0.5f : a3;
    float r6 = inb ? (a4 + s[4]) * 0.25f : a4 * 0.5f;
    float r2 = (a0 - (inb ? s[0] : 0.0f)) * 0.5f;
    float r3 = (a1 - (inb ? s[1] : 0.0f)) * 0.5f;
    r2 = r2 + r4 * dy + r6 * dx;
    r3 = r3 + r6 * dy + r5 * dx;

    const float sc = (float)(edge_weight(y, H) * edge_weight(x, W));
    r2 = r2 * sc;
    r3 = r3 * sc;
    r4 = r4 * sc;
    r5 = r5 * sc;
    r6 = r6 * sc;

    m_s[idx] = r4 * r4 + r6 * r6;
    m_s[plane + idx] = (r4 + r5) * r6;
    m_s[2 * plane + idx] = r5 * r5 + r6 * r6;
    m_s[3 * plane + idx] = r4 * r2 + r6 * r3;
    m_s[4 * plane + idx] = r6 * r2 + r5 * r3;
  }
  __syncthreads();

  // ---- phase 2: box sum over the window, 2x2 solve ----
  const int x = tx0 + threadIdx.x;
  if (x >= W) return;
  const int k = 2 * r + 1;
  for (int oy = threadIdx.y; oy < TILE_Y; oy += BLOCK_Y) {
    const int y = ty0 + oy;
    if (y >= H) break;
    float g[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float* mc = m_s + c * plane + oy * sw + threadIdx.x;
      float acc = 0.0f;
      for (int j = 0; j < k; ++j) {       // columns of the window
        float col = 0.0f;
        for (int i = 0; i < k; ++i) col += mc[i * sw + j];   // rows
        acc += col;
      }
      g[c] = acc * inv_ws2;
    }
    const float g11 = g[0], g12 = g[1], g22 = g[2], h1 = g[3], h2 = g[4];
    const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
    const long long p = (long long)y * W + x;
    flow_out[b * 2 * hw + p] = (g11 * h2 - g12 * h1) * idet;
    flow_out[b * 2 * hw + hw + p] = (g22 * h1 - g12 * h2) * idet;
  }
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
  const size_t smem =
      sizeof(float) * 5 * (size_t)(TILE_X + 2 * r) * (TILE_Y + 2 * r);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        umuf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + TILE_X - 1) / TILE_X, (H + TILE_Y - 1) / TILE_Y, B);
  const dim3 block(BLOCK_X, BLOCK_Y);
  umuf_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      r0, r1, flow_in, flow_out, H, W, d, clamp, r, inv_ws2);
  return (int)cudaGetLastError();
}
