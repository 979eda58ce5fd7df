// K-umuf: k chained Farneback iterations at one pyramid level in one launch.
//
// Replaces the Pallas TPU kernel flowdenoising_tpu/ops/pallas/umuf.py:
// _umuf_kernel -> _phase1_phase2 (reached through umuf_iterate_prepped).
// The plain PyTorch version is flowdenoising_tpu_torch/ops/farneback.py:
// umuf_iterate_plain, i.e. k times
// update_flow_plain(update_matrices_plain(r0, r1, flow, d), winsize).
//
// Phase 1 (per pixel, farneback.cuh: matrices_from): sample the five
// channels of the reference expansion r1 bilinearly at (x + u, y + v), u
// and v clamped to +-d (no clamp when `clamp` is 0), replicate borders;
// mask out-of-plane samples using the UNCLAMPED flow; average the
// quadratic terms with r0; add the flow terms with the unclamped flow;
// scale by the 5-px border ramp; form M = [G11, G12, G22, h1, h2].
// Phase 2 (farneback.cuh: box_solve): box-sum M over (2r+1)^2, r =
// winsize/2, with borders replicating the true edge M; scale by
// 1/winsize^2; solve the 2x2 system regularised by +1e-3.
//
// What bounds it on the H100.  The function must read r0 and r1 once and
// read and write the flow once: 56 B per pixel, 0.28 ms at (256, 5, 256,
// 256); its arithmetic (~70 flops of phase 1, 2*(2r+1) adds per channel of
// a separable box sum) is far under the card's float32 rate.  The design
// keeps every intermediate out of device memory, so device memory is not
// what limits it now (PERF.md): a block's time goes to phase 1, whose 20
// bilinear taps of r1 per pixel come from L2 and L1 at the rate the flow's
// scatter allows, and to the box sums in shared memory; the phases of a
// block run one after another between barriers, with two blocks on an SM.
// The design:
// - All k iterations of a level run in one launch (the TPU kernel's
//   r*iters context rows, umuf.py:97-105, carried to 2-D tiles).  A block
//   owns a TY x TX output tile.  Iteration j computes M on the tile
//   grown by (k-j)*r on every side and writes the flow on the tile grown by
//   (k-1-j)*r: each iteration's flow region shrinks by r, the window's
//   reach, so every window reads M that this block computed, and only the
//   last iteration writes device memory.  The flow makes one round trip
//   through device memory a launch, not one an iteration; the later
//   iterations read r0 and r1 again, mostly from L2 and L1.
// - Every region is clamped to the plane, and M and the flow carry are
//   stored at plane coordinates relative to the region's origin: a window
//   that crosses the plane's edge clamps to the true edge M, exactly as the
//   plain version's replicate border (M is never computed from padded
//   inputs, flowdenoising_tpu/ops/pallas/umuf.py:14-26), and a window never
//   crosses an interior tile edge.  So the output does not depend on the
//   tile or on k, bit for bit.
// - Phase 2 is the separable sum of farneback.cuh: box_solve, 2*(2r+1)
//   shared loads per pixel and channel instead of (2r+1)^2, in the plain
//   version's order (rows of the window first, then columns, taps in
//   ascending order, each window summed afresh).  With -fmad=false every
//   result equals the plain version's bit for bit.
// - Shared memory per block: M, 5 planes of (RH + r) x SW floats (r spare
//   rows for the in-place row sums), and for k > 1 the flow carry, 2 planes
//   of RH x SW, where RH x SW = (TY + 2kr) x (TX + 2kr) clamped to the
//   plane: 28 B per region pixel.  The flow carry also holds the new flow:
//   phase 1 of an iteration has read it before phase 2 overwrites it.
// - The planner in ops/cuda/umuf.py picks TY, TX and k from (H, W,
//   winsize, iterations): the largest k whose tile fits two blocks on an SM
//   with no more than twice the tile's phase-1 work; the iterations then run
//   as ceil(iterations / k) launches.
// - r1's 20 bilinear taps a pixel are read through __ldg, from L1 and L2:
//   a window of float32 r1 in shared memory would take tens of KB more per
//   tile and halve the blocks an SM holds.  Staging the flow in shared
//   memory first, prefetching the region's r0 and r1 into L2, two cells a
//   thread at once and 384-thread blocks were each measured and gained
//   nothing (PERF.md).
// - No tensor cores: the only product in the function is the box sum's
//   0/1 band (the TPU kernel's MXU box matmul), and TF32 would round M to a
//   10-bit mantissa, which breaks the bit equality and can miss the JAX
//   package's tolerance.
// - The packed form (K-umuf-bf16, --precision bfloat16: the TPU kernel's
//   `packed` r1, umuf.py:262-263) is this kernel with r1 read as bfloat16
//   (T1 = __nv_bfloat16, bf16.cuh): r1's 10 B per pixel instead of 20, so
//   the function's bytes fall from 56 to 46 B per pixel, and the plan does
//   not change.  At the half width r1's window for a tile does fit beside
//   M and the flow carry with two blocks an SM, and a body that copied it
//   into shared memory with TMA once a launch was measured on the card: it
//   was bit-identical and 16-28% slower at every level the bf16 paths run
//   packed (PERF.md).  The gathers of r1 cost less than the window's copy
//   (4.4x the tile's texels at 256^2, d 9) and the smaller tile it needs,
//   so r1 stays out of shared memory here too.  `ramp_bf16` rounds the
//   border ramp to bfloat16, as a bf16 pass's tiny levels hold it in the
//   JAX package (farneback.py: update_matrices, `scale` in r0.dtype).
// Built with -fmad=false so the arithmetic rounds as the plain version's
// separate multiplies and adds do.

#include "farneback.cuh"

namespace {

template <typename T1>
__global__ void __launch_bounds__(512, 2)
umuf_kernel(const float* __restrict__ r0, const T1* __restrict__ r1,
            const float* __restrict__ flow_in, float* __restrict__ flow_out,
            int H, int W, float d, int clamp, int ramp_bf16, int r,
            float inv_ws2, int k, int TY, int TX, int rh, int sw) {
  extern __shared__ float smem[];
  const int mplane = (rh + r) * sw;
  float* m_s = smem;              // M at array row y - ry0 + r, column x - rx0
  float* fu = smem + 5 * mplane;  // flow carry at row y - ry0, column x - rx0
  float* fv = fu + rh * sw;
  const long long hw = (long long)H * W;
  const long long b = blockIdx.z;
  const float* R0 = r0 + b * 5 * hw;
  const T1* R1 = r1 + b * 5 * hw;
  const float* U = flow_in + b * 2 * hw;
  const float* V = U + hw;
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
      float dx, dy;
      if (j == 0) {
        const long long p = (long long)y * W + x;
        dx = U[p];
        dy = V[p];
      } else {
        const int q = (y - ry0) * sw + (x - rx0);
        dx = fu[q];
        dy = fv[q];
      }
      float m[5];
      matrices_from(R0, R1, dx, dy, x, y, H, W, hw, d, clamp, ramp_bf16, m);
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

// The launch of fdt_umuf and fdt_umuf_bf16.
template <typename T1>
int launch_umuf(const float* r0, const T1* r1, const float* flow_in,
                float* flow_out, int B, int H, int W, float d, int clamp,
                int ramp_bf16, int winsize, float inv_ws2, int k, int TY,
                int TX, int threads, void* stream) {
  if (B == 0 || H == 0 || W == 0 || k == 0) return (int)cudaSuccess;
  if (k < 0 || TY < 1 || TX < 1 || threads < 32 || threads > 512)
    return (int)cudaErrorInvalidValue;
  const int r = winsize / 2;
  const int rh = min(TY + 2 * k * r, H);
  const int sw = min(TX + 2 * k * r, W);
  const size_t smem = umuf_smem_bytes(rh, sw, r, k);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(umuf_kernel<T1>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  umuf_kernel<T1><<<grid, threads, smem, (cudaStream_t)stream>>>(
      r0, r1, flow_in, flow_out, H, W, d, clamp, ramp_bf16, r, inv_ws2, k, TY,
      TX, rh, sw);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one block of fdt_umuf takes: the planner's formula, for
// the card tests to hold it to.
extern "C" long long fdt_umuf_smem(int H, int W, int winsize, int k, int TY,
                                   int TX) {
  const int r = winsize / 2;
  return (long long)umuf_smem_bytes(min(TY + 2 * k * r, H),
                                    min(TX + 2 * k * r, W), r, k);
}

// k chained iterations in one launch.  r0, r1: (B, 5, H, W); flow_in,
// flow_out: (B, 2, H, W); all contiguous float32, flow_out distinct from
// flow_in.  inv_ws2 is 1/winsize^2 rounded to float32; ramp_bf16 rounds the
// border ramp to bfloat16.  TY x TX is the output tile of a block of
// `threads` threads (at most 512).  Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a block that does not
// fit the card.
extern "C" int fdt_umuf(const float* r0, const float* r1,
                        const float* flow_in, float* flow_out, int B, int H,
                        int W, float d, int clamp, int ramp_bf16, int winsize,
                        float inv_ws2, int k, int TY, int TX, int threads,
                        void* stream) {
  return launch_umuf(r0, r1, flow_in, flow_out, B, H, W, d, clamp, ramp_bf16,
                     winsize, inv_ws2, k, TY, TX, threads, stream);
}

// The packed form: fdt_umuf with r1 contiguous bfloat16.
extern "C" int fdt_umuf_bf16(const float* r0, const __nv_bfloat16* r1,
                             const float* flow_in, float* flow_out, int B,
                             int H, int W, float d, int clamp, int ramp_bf16,
                             int winsize, float inv_ws2, int k, int TY, int TX,
                             int threads, void* stream) {
  return launch_umuf(r0, r1, flow_in, flow_out, B, H, W, d, clamp, ramp_bf16,
                     winsize, inv_ws2, k, TY, TX, threads, stream);
}
