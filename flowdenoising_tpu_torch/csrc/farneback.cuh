// The two phases of a Farneback iteration, shared by K-umuf (umuf.cu: both
// phases in one launch, M kept in shared memory), K-um (um.cu: phase 1,
// M written to device memory) and K-uf (uf.cu: phase 2 on an M read from
// device memory).  The plain PyTorch versions are
// flowdenoising_tpu_torch/ops/farneback.py: update_matrices_plain and
// update_flow_plain.  The arithmetic is written in the plain versions'
// order, for a build with -fmad=false.

#pragma once

#include <cuda_runtime.h>

namespace {

// A block of BLOCK_X x BLOCK_Y threads owns a TILE_X x TILE_Y output tile
// of phase 2; its M tile in shared memory carries a halo of r = winsize/2
// on every side: 5 planes of (TILE_Y + 2r) x (TILE_X + 2r) floats.
constexpr int TILE_X = 32;
constexpr int TILE_Y = 16;
constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

__host__ __device__ constexpr size_t tile_smem_bytes(int r) {
  return sizeof(float) * 5 * (size_t)(TILE_X + 2 * r) * (TILE_Y + 2 * r);
}

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

// Phase 1: M = [G11, G12, G22, h1, h2] at plane pixel (x, y) of one batch
// entry.  R0, R1: that entry's (5, H, W) expansions; U, V: its flow planes;
// hw = H * W.
//
// Sample the five channels of r1 bilinearly at (x + u, y + v), u and v
// clamped to +-d (no clamp when `clamp` is 0), replicate borders; mask
// out-of-plane samples using the UNCLAMPED flow; average the quadratic
// terms with r0; add r4*dy + r6*dx and r6*dy + r5*dx with the unclamped
// flow; scale by the 5-px border ramp at plane coordinates.
__device__ __forceinline__ void matrices_at(const float* __restrict__ R0,
                                            const float* __restrict__ R1,
                                            const float* __restrict__ U,
                                            const float* __restrict__ V,
                                            int x, int y, int H, int W,
                                            long long hw, float d, int clamp,
                                            float m[5]) {
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
  // bound the floor before the integer cast: an unclamped flow can be
  // huge, and every x0 outside [-1, W] selects the same edge pair
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

  m[0] = r4 * r4 + r6 * r6;
  m[1] = (r4 + r5) * r6;
  m[2] = r5 * r5 + r6 * r6;
  m[3] = r4 * r2 + r6 * r3;
  m[4] = r6 * r2 + r5 * r3;
}

// Phase 2 for the block's output tile at (tx0, ty0): box-sum the shared M
// tile m_s (5 planes of sw x (TILE_Y + 2r), halo included) over the
// (2r+1)^2 window -- rows of each window column first, then the columns,
// in ascending order as the plain separable sum adds them -- scale by
// inv_ws2 = 1/winsize^2 (not 1/(2r+1)^2: they differ for an even winsize)
// and solve the 2x2 system regularised by +1e-3.  Writes the flow planes
// U_out, V_out of the batch entry.
__device__ __forceinline__ void box_solve_tile(const float* m_s, int tx0,
                                               int ty0, int H, int W, int r,
                                               float inv_ws2,
                                               float* __restrict__ U_out,
                                               float* __restrict__ V_out) {
  const int sw = TILE_X + 2 * r;
  const int plane = sw * (TILE_Y + 2 * r);
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
    U_out[p] = (g11 * h2 - g12 * h1) * idet;
    V_out[p] = (g22 * h1 - g12 * h2) * idet;
  }
}

// Raise a kernel's dynamic shared-memory limit when a tile needs more than
// the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace
