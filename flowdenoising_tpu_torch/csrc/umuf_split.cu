// K-umuf-split: the bf16 pass's split Farneback iteration with no
// displacement bound, phase 1 and every iteration of a pyramid level in one
// launch.
//
// Replaces the Pallas TPU kernel flowdenoising_tpu/ops/pallas/
// update_flow.py:32 _uf_kernel (B5) on the split route (--dtype bfloat16
// --max_displacement 0), together with the phase 1 that the JAX package runs
// in XLA before it there (flowdenoising_tpu/ops/farneback.py: _iterate_level
// with no bound on a bf16 pyramid: its fused kernel sizes a VMEM window of
// r1 from the bound, and with none it splits the iteration).  The plain
// PyTorch version is flowdenoising_tpu_torch/ops/farneback.py:
// split_iterate_plain, i.e. k times
// update_flow_plain(update_matrices_xla(r0, r1, flow).float(), winsize).
//
// Phase 1 (matrices_split below) is update_matrices_xla at one pixel, each
// operation rounded where PyTorch rounds it; r0 and r1 are bf16, so:
// - the pixel coordinates are bf16: torch.arange(w, dtype=bfloat16) rounds
//   integers past 256 to even (257 -> 256, 259 -> 260);
// - with a float32 flow (every iteration but one) the coordinates, floors,
//   fractions, lerps and M are float32, but v01 - v00 and v11 - v10 (bf16 -
//   bf16) round to bf16, and so does the masked-out a4 * 0.5;
// - with a bf16 flow (the first iteration of the coarsest level, from a
//   bf16 zero flow or seed) every operation rounds to bf16, left to right as
//   ops/farneback.py: _normal_equations writes it, and the in-plane test
//   compares the bf16 floor with W - 2 and H - 2 cast to bf16 (bf16(1024)
//   <= 1022 holds); M is bf16, widened exactly for phase 2;
// - no clamp: the floor is bounded to [-1, W] x [-1, H] before the integer
//   cast, as ops/warp.py: bilinear_sample and farneback.cuh: matrices_from
//   bound it, so a flow far outside the plane selects the edge pair;
// - the border scale is the float64 ramp map cast to bf16, which c10's
//   BFloat16 conversion takes through float32.
// Phase 2 is farneback.cuh: box_solve, K-uf's and K-umuf's arithmetic.
// Built with -fmad=false and subnormals kept, every result equals the plain
// version's bit for bit.
//
// What bounds it on the H100.  The function must read r0 and r1 once
// (bf16, 10 B a pixel each) and read and write the flow once (float32, 8 B
// each): 36 B a pixel, 0.180 ms at (256, 5, 256, 256) and 3.35 TB/s.  Its
// operations (~70 a pixel and iteration in phase 1, the bf16 roundings,
// 2*(2r+1) adds a channel in the box sum) are far below 67 TFLOP/s float32.
// The split iteration as the TPU path runs it moves far more: phase 1 in
// ~100 plain kernels a call, M written as float32 and read back by K-uf at
// every iteration.  The design is K-umuf's (umuf.cu), and what it does
// about that bound is the same:
// - All k iterations of a level run in one launch, one block per TY x TX
//   output tile; iteration j computes M on the tile grown by (k-j)*r and the
//   flow on the tile grown by (k-1-j)*r, every region clamped to the plane,
//   so every window reads M this block computed and replicates the true
//   edge M at the plane's edge.  M (5 float32 planes) and the flow carry (2)
//   live in shared memory, 28 B per region pixel, so ops/cuda/umuf.py:
//   plan_umuf plans this kernel unchanged (k = 3 a launch at the defaults):
//   no intermediate goes to device memory, and the flow makes one round
//   trip a launch.
// - r1's 20 bilinear taps a pixel are read through __ldg with no clamp, and
//   r1 stays out of shared memory: with no bound the window a tile reads is
//   unbounded, and where a window was bounded, staging it cost K-umuf-bf16
//   16-28% (PERF.md).
// - Only the first iteration reads the input flow, so the kernel is a
//   template on its type (bf16 or float32); the carry is float32.
// - K-umuf's tile loop is not shared with this kernel: a shared loop cost
//   K-umuf 2-4% (PERF.md), so umuf.cu keeps its own.

#include <type_traits>

#include "farneback.cuh"

namespace {

using bf16 = __nv_bfloat16;

// x rounded to bfloat16 where BF is set (an operation PyTorch runs in bf16:
// both operands bf16), else x (an operation in float32).
template <bool BF>
__device__ __forceinline__ float rnd(float x) {
  return BF ? round_bf16(x) : x;
}

// Phase 1 of the split iteration at plane pixel (x, y) of one batch entry:
// M = [G11, G12, G22, h1, h2] as ops/farneback.py: update_matrices_xla
// computes it, widened to float32.  R0, R1: that entry's (5, H, W) bf16
// expansions; (dx, dy): the flow at (x, y); hw = H * W.  BF: the flow is
// bf16 and every operation rounds to bf16; else the flow is float32.
template <bool BF>
__device__ __forceinline__ void matrices_split(const bf16* __restrict__ R0,
                                               const bf16* __restrict__ R1,
                                               float dx, float dy, int x,
                                               int y, int H, int W,
                                               long long hw, float m[5]) {
  const long long p = (long long)y * W + x;
  const float gx = round_bf16((float)x);
  const float gy = round_bf16((float)y);
  const float fx = rnd<BF>(gx + dx);
  const float fy = rnd<BF>(gy + dy);
  float x0f = floorf(fx);
  float y0f = floorf(fy);
  // a bf16 floor is compared with W - 2 and H - 2 cast to bf16
  const float xlast = rnd<BF>((float)(W - 2));
  const float ylast = rnd<BF>((float)(H - 2));
  const bool inb = x0f >= 0.0f && x0f <= xlast && y0f >= 0.0f && y0f <= ylast;
  const float tx = rnd<BF>(fx - x0f);
  const float ty = rnd<BF>(fy - y0f);
  // bound the floor before the integer cast: every x0 outside [-1, W]
  // selects the same edge pair
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
    const bf16* q = R1 + c * hw;
    const float v00 = load_f32(q + ra + xa);
    const float v01 = load_f32(q + ra + xb);
    const float v10 = load_f32(q + rb + xa);
    const float v11 = load_f32(q + rb + xb);
    // bf16 - bf16 rounds to bf16 whatever the flow's dtype
    const float top = rnd<BF>(v00 + rnd<BF>(round_bf16(v01 - v00) * tx));
    const float bot = rnd<BF>(v10 + rnd<BF>(round_bf16(v11 - v10) * tx));
    s[c] = rnd<BF>(top + rnd<BF>(rnd<BF>(bot - top) * ty));
  }
  const float a0 = load_f32(R0 + p), a1 = load_f32(R0 + hw + p);
  const float a2 = load_f32(R0 + 2 * hw + p), a3 = load_f32(R0 + 3 * hw + p);
  const float a4 = load_f32(R0 + 4 * hw + p);

  float r4 = inb ? rnd<BF>(rnd<BF>(a2 + s[2]) * 0.5f) : a2;
  float r5 = inb ? rnd<BF>(rnd<BF>(a3 + s[3]) * 0.5f) : a3;
  // a4 * 0.5 is bf16 * scalar: bf16 whatever the flow's dtype
  float r6 = inb ? rnd<BF>(rnd<BF>(a4 + s[4]) * 0.25f) : round_bf16(a4 * 0.5f);
  float r2 = rnd<BF>(rnd<BF>(a0 - (inb ? s[0] : 0.0f)) * 0.5f);
  float r3 = rnd<BF>(rnd<BF>(a1 - (inb ? s[1] : 0.0f)) * 0.5f);
  r2 = rnd<BF>(rnd<BF>(r2 + rnd<BF>(r4 * dy)) + rnd<BF>(r6 * dx));
  r3 = rnd<BF>(rnd<BF>(r3 + rnd<BF>(r6 * dy)) + rnd<BF>(r5 * dx));

  const float sc = round_bf16((float)(edge_weight(y, H) * edge_weight(x, W)));
  r2 = rnd<BF>(r2 * sc);
  r3 = rnd<BF>(r3 * sc);
  r4 = rnd<BF>(r4 * sc);
  r5 = rnd<BF>(r5 * sc);
  r6 = rnd<BF>(r6 * sc);

  m[0] = rnd<BF>(rnd<BF>(r4 * r4) + rnd<BF>(r6 * r6));
  m[1] = rnd<BF>(rnd<BF>(r4 + r5) * r6);
  m[2] = rnd<BF>(rnd<BF>(r5 * r5) + rnd<BF>(r6 * r6));
  m[3] = rnd<BF>(rnd<BF>(r4 * r2) + rnd<BF>(r6 * r3));
  m[4] = rnd<BF>(rnd<BF>(r6 * r2) + rnd<BF>(r5 * r3));
}

// K-umuf's tile loop (umuf.cu: umuf_kernel) over matrices_split.  FlowT is
// the input flow's type; the first iteration reads it, the later ones the
// float32 carry.
template <typename FlowT>
__global__ void __launch_bounds__(512, 2)
umuf_split_kernel(const bf16* __restrict__ r0, const bf16* __restrict__ r1,
                  const FlowT* __restrict__ flow_in,
                  float* __restrict__ flow_out, int H, int W, int r,
                  float inv_ws2, int k, int TY, int TX, int rh, int sw) {
  extern __shared__ float smem[];
  const int mplane = (rh + r) * sw;
  float* m_s = smem;              // M at array row y - ry0 + r, column x - rx0
  float* fu = smem + 5 * mplane;  // flow carry at row y - ry0, column x - rx0
  float* fv = fu + rh * sw;
  const long long hw = (long long)H * W;
  const long long b = blockIdx.z;
  const bf16* R0 = r0 + b * 5 * hw;
  const bf16* R1 = r1 + b * 5 * hw;
  const FlowT* U = flow_in + b * 2 * hw;
  const FlowT* V = U + hw;
  float* Uo = flow_out + b * 2 * hw;
  float* Vo = Uo + hw;

  // the output tile and the first iteration's region, clamped to the plane
  const int ty0 = blockIdx.y * TY, tx0 = blockIdx.x * TX;
  const int ty1 = min(ty0 + TY, H) - 1, tx1 = min(tx0 + TX, W) - 1;
  const int ry0 = max(ty0 - k * r, 0), rx0 = max(tx0 - k * r, 0);

  for (int j = 0; j < k; ++j) {
    // ---- phase 1: M on the tile grown by (k - j) * r ----
    const int mc = (k - j) * r;
    const int my0 = max(ty0 - mc, 0), my1 = min(ty1 + mc, H - 1);
    const int mx0 = max(tx0 - mc, 0), mx1 = min(tx1 + mc, W - 1);
    for_cells(my1 - my0 + 1, mx1 - mx0 + 1, [&](int ly, int lx) {
      const int y = my0 + ly, x = mx0 + lx;
      float m[5];
      if (j == 0) {
        const long long p = (long long)y * W + x;
        matrices_split<std::is_same_v<FlowT, bf16>>(
            R0, R1, load_f32(U + p), load_f32(V + p), x, y, H, W, hw, m);
      } else {
        const int q = (y - ry0) * sw + (x - rx0);
        matrices_split<false>(R0, R1, fu[q], fv[q], x, y, H, W, hw, m);
      }
      const int a = (y - ry0 + r) * sw + (x - rx0);
#pragma unroll
      for (int c = 0; c < 5; ++c) m_s[c * mplane + a] = m[c];
    });
    __syncthreads();

    // ---- phase 2: the flow on the tile grown by (k - 1 - j) * r ----
    const int oc = mc - r;
    const int oy0 = max(ty0 - oc, 0), oy1 = min(ty1 + oc, H - 1);
    const int ox0 = max(tx0 - oc, 0), ox1 = min(tx1 + oc, W - 1);
    const BoxWindow g = {oy0 - ry0, my0 - ry0 + r, my1 - ry0 + r,
                         ox0 - r - rx0, mx0 - rx0, mx1 - rx0,
                         oy1 - oy0 + 1, ox1 - ox0 + 1};
    if (j == k - 1) {
      const long long p = (long long)oy0 * W + ox0;
      box_solve(m_s, mplane, sw, r, g, inv_ws2, Uo + p, Vo + p, W);
    } else {
      const int q = (oy0 - ry0) * sw + (ox0 - rx0);
      box_solve(m_s, mplane, sw, r, g, inv_ws2, fu + q, fv + q, sw);
    }
    __syncthreads();
  }
}

template <typename FlowT>
int launch_umuf_split(const bf16* r0, const bf16* r1, const FlowT* flow_in,
                      float* flow_out, int B, int H, int W, int winsize,
                      float inv_ws2, int k, int TY, int TX, int threads,
                      void* stream) {
  if (B == 0 || H == 0 || W == 0 || k == 0) return (int)cudaSuccess;
  if (k < 0 || TY < 1 || TX < 1 || threads < 32 || threads > 512)
    return (int)cudaErrorInvalidValue;
  const int r = winsize / 2;
  const int rh = min(TY + 2 * k * r, H);
  const int sw = min(TX + 2 * k * r, W);
  const size_t smem = umuf_smem_bytes(rh, sw, r, k);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(umuf_split_kernel<FlowT>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  umuf_split_kernel<FlowT><<<grid, threads, smem, (cudaStream_t)stream>>>(
      r0, r1, flow_in, flow_out, H, W, r, inv_ws2, k, TY, TX, rh, sw);
  return (int)cudaGetLastError();
}

}  // namespace

// k chained split iterations in one launch.  r0, r1: (B, 5, H, W)
// contiguous bfloat16; flow_in: (B, 2, H, W) contiguous, bfloat16 when
// flow_bf16 is set, else float32; flow_out: (B, 2, H, W) contiguous
// float32, distinct from flow_in.  inv_ws2 is 1/winsize^2 rounded to
// float32.  TY x TX is the output tile of a block of `threads` threads (at
// most 512), as ops/cuda/umuf.py: plan_umuf plans it.  Launches on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue for a
// block that does not fit the card.
extern "C" int fdt_umuf_split(const bf16* r0, const bf16* r1,
                              const void* flow_in, int flow_bf16,
                              float* flow_out, int B, int H, int W,
                              int winsize, float inv_ws2, int k, int TY, int TX,
                              int threads, void* stream) {
  if (flow_bf16)
    return launch_umuf_split(r0, r1, static_cast<const bf16*>(flow_in),
                             flow_out, B, H, W, winsize, inv_ws2, k, TY, TX,
                             threads, stream);
  return launch_umuf_split(r0, r1, static_cast<const float*>(flow_in),
                           flow_out, B, H, W, winsize, inv_ws2, k, TY, TX,
                           threads, stream);
}
