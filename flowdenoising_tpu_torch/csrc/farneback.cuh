// The two phases of a Farneback iteration, shared by K-umuf (umuf.cu: all
// iterations of a level in one launch, M and the flow carry kept in shared
// memory), K-um (um.cu: phase 1, M written to device memory) and K-uf
// (uf.cu: phase 2 on an M read from device memory); K-umuf-split
// (umuf_split.cu) has its own phase 1 and takes phase 2 from here.  The
// plain PyTorch versions are flowdenoising_tpu_torch/ops/farneback.py:
// update_matrices_plain and update_flow_plain.  The arithmetic is written in
// the plain versions' order, for a build with -fmad=false.
//
// Phase 1 is a template on the element type of r1: float32, or bfloat16 in
// the packed forms of K-umuf and K-um (--precision bfloat16), which widen
// each r1 texel exactly (bf16.cuh) and compute in float32 from there.

#pragma once

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

// K-um's and K-uf's blocks are BLOCK_X x BLOCK_Y threads (K-um: one pixel
// a thread).  A K-uf block owns a TILE_X x TILE_Y output tile; its M tile
// in shared memory carries a halo of r = winsize/2 on every side: 5 planes
// of (TILE_Y + 2r) x (TILE_X + 2r) floats.  K-umuf takes its tile from
// the wrapper's planner.
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
// flow; scale by the 5-px border ramp at plane coordinates, rounded to
// bfloat16 when `ramp_bf16` is set (the JAX package's split iteration on a
// bf16 pass's tiny levels holds the ramp map in the pass dtype).  (dx, dy)
// is the flow at (x, y): M depends on the flow at its own pixel only.
template <typename T1>
__device__ __forceinline__ void matrices_from(const float* __restrict__ R0,
                                              const T1* __restrict__ R1,
                                              float dx, float dy, int x, int y,
                                              int H, int W, long long hw,
                                              float d, int clamp, int ramp_bf16,
                                              float m[5]) {
  const long long p = (long long)y * W + x;
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
    const T1* q = R1 + c * hw;
    const float v00 = load_f32(q + ra + xa);
    const float v01 = load_f32(q + ra + xb);
    const float v10 = load_f32(q + rb + xa);
    const float v11 = load_f32(q + rb + xb);
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

  float sc = (float)(edge_weight(y, H) * edge_weight(x, W));
  if (ramp_bf16) sc = round_bf16(sc);
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

// Phase 1 at plane pixel (x, y) with the flow read from the planes U, V.
template <typename T1>
__device__ __forceinline__ void matrices_at(const float* __restrict__ R0,
                                            const T1* __restrict__ R1,
                                            const float* __restrict__ U,
                                            const float* __restrict__ V,
                                            int x, int y, int H, int W,
                                            long long hw, float d, int clamp,
                                            int ramp_bf16, float m[5]) {
  const long long p = (long long)y * W + x;
  matrices_from(R0, R1, U[p], V[p], x, y, H, W, hw, d, clamp, ramp_bf16, m);
}

// Calls f(i, j) for every cell of a rows x cols rectangle, the cells
// dealt round the block's threads in row-major order (one division per
// thread, not one per cell).
template <typename F>
__device__ __forceinline__ void for_cells(int rows, int cols, F f) {
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int di = nt / cols, dj = nt - di * cols;
  int i = tid / cols, j = tid - (tid / cols) * cols;
  while (i < rows) {
    f(i, j);
    i += di;
    j += dj;
    if (j >= cols) {
      j -= cols;
      ++i;
    }
  }
}

// Where phase 2 finds the window of each output pixel in a block's M tile
// (array rows and columns, `sw` floats a row).  Output row o sums array
// rows clamp(rfirst + o + i, rlo, rhi), i = 0..2r; output column q sums
// array columns clamp(cfirst + q + j, clo, chi), j = 0..2r.  The clamps
// replicate the true edge M of the plane; within a tile they never act.
struct BoxWindow {
  int rfirst, rlo, rhi;
  int cfirst, clo, chi;
  int rows, cols;          // output pixels
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// Phase 2 of a Farneback iteration on the M tile m_s (5 planes, `plane`
// floats apart): the replicate-border box sum over the (2r+1)^2 window,
// scaled by inv_ws2 = 1/winsize^2 (not 1/(2r+1)^2: they differ for an even
// winsize), and the 2x2 solve regularised by +1e-3.  Output pixel (o, q)
// goes to U_out[o * ostride + q], V_out[o * ostride + q].  Every thread of
// the block calls it (it synchronises inside) after the tile is complete;
// it overwrites the tile.
//
// The sum is separable, in the plain version's order (ops/blur.py:
// corr1d along H, then along W, each adding its taps in ascending order),
// so with -fmad=false it rounds exactly as the plain version does:
// 1. one thread per channel and array column sums the 2r+1 window rows
//    of each output row top-down, afresh for every row (a running sum
//    that adds one row and drops another rounds differently), and writes
//    the sum over the first row of that window: every later window of the
//    column starts lower, so no sum reads a row already overwritten, and
//    no other thread reads the column before the barrier;
// 2. one thread per output pixel sums 2r+1 of those row sums for each
//    channel and solves.
// That is 2*(2r+1) shared loads per output pixel and channel (pass 1's
// share grown by the tile's column halo), where summing each window whole
// took (2r+1)^2.  For r <= 7 (winsize <= 15) the window is a compile-time
// size R: pass 1 keeps the column's last 2R+1 rows in registers, so it
// loads one row per output row (the sum is still taken afresh over the
// registers), and pass 2 reads an unclamped window at fixed offsets
// wherever it lies inside the tile.  R = -1 takes r at run time.
template <int R>
__device__ __forceinline__ void box_solve_r(float* m_s, int plane, int sw,
                                            int r, const BoxWindow& g,
                                            float inv_ws2,
                                            float* __restrict__ U_out,
                                            float* __restrict__ V_out,
                                            int ostride) {
  if constexpr (R >= 0) r = R;
  const int taps = 2 * r + 1;
  const int ncols = g.chi - g.clo + 1;
  for_cells(5, ncols, [&](int c, int j) {
    float* col = m_s + c * plane + g.clo + j;
    if constexpr (R >= 0) {
      constexpr int T = 2 * R + 1;
      float v[T];
#pragma unroll
      for (int i = 0; i + 1 < T; ++i)
        v[i + 1] = col[clampi(g.rfirst + i, g.rlo, g.rhi) * sw];
      for (int o = 0; o < g.rows; ++o) {
#pragma unroll
        for (int i = 0; i + 1 < T; ++i) v[i] = v[i + 1];
        v[T - 1] = col[clampi(g.rfirst + o + T - 1, g.rlo, g.rhi) * sw];
        float acc = v[0];
#pragma unroll
        for (int i = 1; i < T; ++i) acc += v[i];
        col[(g.rfirst + o) * sw] = acc;
      }
    } else {
      for (int o = 0; o < g.rows; ++o) {
        float acc = col[clampi(g.rfirst + o, g.rlo, g.rhi) * sw];
        for (int i = 1; i < taps; ++i)
          acc += col[clampi(g.rfirst + o + i, g.rlo, g.rhi) * sw];
        col[(g.rfirst + o) * sw] = acc;
      }
    }
  });
  __syncthreads();
  for_cells(g.rows, g.cols, [&](int o, int q) {
    const float* row = m_s + (g.rfirst + o) * sw;
    float s[5];
    const int cf = g.cfirst + q;
    if (R >= 0 && cf >= g.clo && cf + 2 * R <= g.chi) {
      const float* p = row + cf;
#pragma unroll
      for (int c = 0; c < 5; ++c) s[c] = p[c * plane];
#pragma unroll
      for (int j = 1; j < 2 * R + 1; ++j) {
#pragma unroll
        for (int c = 0; c < 5; ++c) s[c] += p[c * plane + j];
      }
    } else {
      const int c0 = clampi(cf, g.clo, g.chi);
#pragma unroll
      for (int c = 0; c < 5; ++c) s[c] = row[c * plane + c0];
      for (int j = 1; j < taps; ++j) {
        const int cj = clampi(cf + j, g.clo, g.chi);
#pragma unroll
        for (int c = 0; c < 5; ++c) s[c] += row[c * plane + cj];
      }
    }
    const float g11 = s[0] * inv_ws2, g12 = s[1] * inv_ws2;
    const float g22 = s[2] * inv_ws2, h1 = s[3] * inv_ws2;
    const float h2 = s[4] * inv_ws2;
    const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
    U_out[o * ostride + q] = (g11 * h2 - g12 * h1) * idet;
    V_out[o * ostride + q] = (g22 * h1 - g12 * h2) * idet;
  });
}

// box_solve_r at the window size r (block-uniform): compile-time for
// r <= 7, else at run time.
__device__ __forceinline__ void box_solve(float* m_s, int plane, int sw,
                                          int r, const BoxWindow& g,
                                          float inv_ws2,
                                          float* __restrict__ U_out,
                                          float* __restrict__ V_out,
                                          int ostride) {
#define FDT_BOX_CASE(n)                                                   \
  case n:                                                                 \
    box_solve_r<n>(m_s, plane, sw, r, g, inv_ws2, U_out, V_out, ostride); \
    return;
  switch (r) {
    FDT_BOX_CASE(0)
    FDT_BOX_CASE(1)
    FDT_BOX_CASE(2)
    FDT_BOX_CASE(3)
    FDT_BOX_CASE(4)
    FDT_BOX_CASE(5)
    FDT_BOX_CASE(6)
    FDT_BOX_CASE(7)
    default:
      box_solve_r<-1>(m_s, plane, sw, r, g, inv_ws2, U_out, V_out, ostride);
  }
#undef FDT_BOX_CASE
}

// Phase 2 for K-uf's output tile at (tx0, ty0): m_s holds the tile plus a
// halo of r, 5 planes of (TILE_Y + 2r) x (TILE_X + 2r), each halo pixel
// the M of its clamped plane coordinate, so the windows need no clamp.
// Writes the flow planes U_out, V_out of the batch entry.
__device__ __forceinline__ void box_solve_tile(float* m_s, int tx0, int ty0,
                                               int H, int W, int r,
                                               float inv_ws2,
                                               float* __restrict__ U_out,
                                               float* __restrict__ V_out) {
  const int sw = TILE_X + 2 * r;
  const int plane = sw * (TILE_Y + 2 * r);
  const BoxWindow g = {0, 0, TILE_Y + 2 * r - 1, 0, 0, sw - 1,
                       min(TILE_Y, H - ty0), min(TILE_X, W - tx0)};
  const long long p = (long long)ty0 * W + tx0;
  box_solve(m_s, plane, sw, r, g, inv_ws2, U_out + p, V_out + p, W);
}

// Shared memory of one K-umuf or K-umuf-split block (umuf.cu,
// umuf_split.cu): M (5 planes of (rh + r) x sw floats) and, when k > 1, the
// flow carry (2 planes of rh x sw).
__host__ __device__ inline size_t umuf_smem_bytes(int rh, int sw, int r,
                                                  int k) {
  return sizeof(float) * ((size_t)5 * (rh + r) * sw +
                          (k > 1 ? (size_t)2 * rh * sw : 0));
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
