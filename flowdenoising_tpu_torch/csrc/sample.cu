// K-sample: displaced bilinear sampling (the solve-mode tap warp).
//
// Replaces the Pallas TPU kernel flowdenoising_tpu/ops/pallas/sample.py:
// _sample_kernel (reached through bilinear_displace_pallas).
//
// out[b, c, y, x] = bilinear(src[b, c], x + u, y + v), with u and v clamped
// to +-d (no clamp when `clamp` is 0) and the four sample indices clamped to
// the plane (replicate borders).  The plain PyTorch version is
// flowdenoising_tpu_torch/ops/warp.py: displace_sample_plain.
//
// What bounds it on the H100: a gather that reads one flow pair and four
// source texels per output texel and does ~15 flops -- far below the
// tensor-core line and below the float32 line too; it is bound by memory
// traffic and by the latency of the dependent loads.  The TPU design (static
// window of row shifts, two-window lane gathers, VMEM-resident planes) exists
// because the TPU has no cheap per-lane gather.  Hopper does, so this kernel
// is the direct form: one thread per output element, neighbouring threads on
// neighbouring x, so the flow loads and most of the four texel loads of a
// warp fall on a few cache lines; the texels go through the read-only cache
// (__ldg), where the overlapping footprints of neighbouring warps hit.
//
// Flow layout: u and v are separate planes, each contiguous in (H, W), with
// a batch stride given in elements -- so the two channels of a channel-first
// (B, 2, H, W) flow are passed as views without a copy.

#include <cuda_runtime.h>

namespace {

__global__ void sample_kernel(const float* __restrict__ src,
                              const float* __restrict__ u,
                              const float* __restrict__ v,
                              float* __restrict__ out,
                              int C, int H, int W, long long uv_stride,
                              float d, int clamp, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int x = (int)(i % W);
  long long t = i / W;
  const int y = (int)(t % H);
  t /= H;                      // t = b * C + c: the source plane
  const long long b = t / C;

  const long long f = b * uv_stride + (long long)y * W + x;
  float du = u[f];
  float dv = v[f];
  if (clamp) {
    du = fminf(fmaxf(du, -d), d);
    dv = fminf(fmaxf(dv, -d), d);
  }
  const float fx = (float)x + du;
  const float fy = (float)y + dv;
  float x0f = floorf(fx);
  float y0f = floorf(fy);
  const float tx = fx - x0f;
  const float ty = fy - y0f;
  // Bound the floor before the integer cast (unclamped flows may be huge);
  // every value outside [-1, W] clamps to the same pair of edge texels.
  x0f = fminf(fmaxf(x0f, -1.0f), (float)W);
  y0f = fminf(fmaxf(y0f, -1.0f), (float)H);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  const int xa = min(max(x0, 0), W - 1);
  const int xb = min(max(x0 + 1, 0), W - 1);
  const int ya = min(max(y0, 0), H - 1);
  const int yb = min(max(y0 + 1, 0), H - 1);

  const float* p = src + t * (long long)H * W;
  const float v00 = __ldg(p + (long long)ya * W + xa);
  const float v01 = __ldg(p + (long long)ya * W + xb);
  const float v10 = __ldg(p + (long long)yb * W + xa);
  const float v11 = __ldg(p + (long long)yb * W + xb);
  const float top = v00 + (v01 - v00) * tx;
  const float bot = v10 + (v11 - v10) * tx;
  out[i] = top + (bot - top) * ty;
}

}  // namespace

// src, out: (B, C, H, W) contiguous float32; u, v: planes (H, W) at
// u + b * uv_stride.  Launches on `stream`; returns cudaGetLastError().
extern "C" int fdt_sample(const float* src, const float* u, const float* v,
                          float* out, int B, int C, int H, int W,
                          long long uv_stride, float d, int clamp,
                          void* stream) {
  const long long total = (long long)B * C * H * W;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  sample_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      src, u, v, out, C, H, W, uv_stride, d, clamp, total);
  return (int)cudaGetLastError();
}
