// K-compose: one tap of the composed-flow pass (--tap_flow compose).
//
// Replaces the Pallas TPU kernel flowdenoising_tpu/ops/pallas/compose.py:
// _compose_kernel (reached through compose_tap_prepped and
// compose_tap_pallas).  The plain PyTorch version is
// flowdenoising_tpu_torch/ops/cuda/compose.py: compose_tap_plain.
//
// Per output pixel (x, y) of batch element b:
//   (u, v)   = flow[b]
//   (s0, s1) = bilinear(link[link_start + b], x + cl(u), y + cl(v))
//   (u', v') = (u + s0, v + s1)                  -- written back UNCLAMPED
//   s        = bilinear(nb[nb_start + b], x + cl(u'), y + cl(v'))
//   acc[b]  += w * s
// where cl clamps to +-d (no clamp when `clamp` is 0) and the four sample
// indices clamp to the plane (replicate borders).  The carried flow is the
// unclamped sum, as in the JAX package's unfused step
// (flowdenoising_tpu/core/axis_filter.py: _of_pass_composed).
//
// What bounds it on the H100: per pixel it reads the flow and the
// accumulator and writes both back (24 B), and gathers two link texels
// quadruples and one neighbour quadruple (>= 12 B of distinct data), for
// ~40 flops -- far below either the tensor-core or the float32 line, so it
// is bound by memory traffic and the latency of the dependent loads (the
// neighbour's addresses depend on the link samples).  The TPU kernel's
// devices (even/odd planes, bf16 pair packing, the dynamic trip loop, row
// tiles, VMEM budgets, the lane-padded carry, scalar prefetch) all answer
// the TPU's lack of a per-lane gather.  Hopper has one, so this is the
// direct form, in the pattern of sample.cu: one thread per pixel,
// neighbouring threads on neighbouring x, texels through the read-only
// cache.  Fusing the step keeps the updated flow and the warped neighbour
// in registers: the unfused form (two K-sample launches, an add and an FMA)
// moves them through device memory.
//
// The link and neighbour stacks are passed whole and read at a batch offset
// (link_start, nb_start), so no tap copies an operand.  flow and acc are
// updated IN PLACE: each thread reads and writes only its own pixel of
// them, and they must not overlap link or nb.
// Built with -fmad=false so the arithmetic rounds as the plain version's
// separate multiplies and adds do.
//
// The bf16 fast mode adds two things, as the JAX package's prepped compose
// pass does (flowdenoising_tpu/ops/pallas/compose.py: prep_compose_src,
// compose_tap_prepped):
// - the packed form (K-compose-bf16, --precision bfloat16): link and nb
//   read as bfloat16 (T = __nv_bfloat16, bf16.cuh) and interpolated in
//   float32, 30 B per pixel of compulsory traffic instead of 36;
// - `round_carry` (--dtype bfloat16, in either form): the flow and acc
//   stores go through bfloat16, as the pass carries them between taps
//   (compose.py:569-574).  The neighbour is still sampled at the unrounded
//   float32 (u', v'); flow and acc stay float32 tensors that hold
//   bf16-exact values.

#include <cuda_runtime.h>

#include "bf16.cuh"

namespace {

// Bilinear footprint of one displaced sample: the two x indices, the two
// row offsets and the fractional weights.
struct Tap {
  int xa, xb;
  long long ra, rb;
  float tx, ty;
};

__device__ __forceinline__ Tap footprint(int x, int y, float du, float dv,
                                         int H, int W, float d, int clamp) {
  if (clamp) {
    du = fminf(fmaxf(du, -d), d);
    dv = fminf(fmaxf(dv, -d), d);
  }
  const float fx = (float)x + du;
  const float fy = (float)y + dv;
  float x0f = floorf(fx);
  float y0f = floorf(fy);
  Tap t;
  t.tx = fx - x0f;
  t.ty = fy - y0f;
  // Bound the floor before the integer cast (the carried flow is unclamped
  // and may be huge); every value outside [-1, W] selects the same edge pair.
  x0f = fminf(fmaxf(x0f, -1.0f), (float)W);
  y0f = fminf(fmaxf(y0f, -1.0f), (float)H);
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  t.xa = min(max(x0, 0), W - 1);
  t.xb = min(max(x0 + 1, 0), W - 1);
  t.ra = (long long)min(max(y0, 0), H - 1) * W;
  t.rb = (long long)min(max(y0 + 1, 0), H - 1) * W;
  return t;
}

template <typename T>
__device__ __forceinline__ float bilinear(const T* __restrict__ p,
                                          const Tap& t) {
  const float v00 = load_f32(p + t.ra + t.xa);
  const float v01 = load_f32(p + t.ra + t.xb);
  const float v10 = load_f32(p + t.rb + t.xa);
  const float v11 = load_f32(p + t.rb + t.xb);
  const float top = v00 + (v01 - v00) * t.tx;
  const float bot = v10 + (v11 - v10) * t.tx;
  return top + (bot - top) * t.ty;
}

template <typename T>
__global__ void compose_kernel(const T* __restrict__ link,
                               const T* __restrict__ nb,
                               float* __restrict__ flow,
                               float* __restrict__ acc,
                               int H, int W, int link_start, int nb_start,
                               float weight, float d, int clamp,
                               int round_carry, long long total) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long hw = (long long)H * W;
  const long long b = i / hw;
  const long long p = i - b * hw;
  const int y = (int)(p / W);
  const int x = (int)(p - (long long)y * W);

  float* U = flow + b * 2 * hw;
  const float u = U[p];
  const float v = U[hw + p];

  const T* L = link + (link_start + b) * 2 * hw;
  const Tap t1 = footprint(x, y, u, v, H, W, d, clamp);
  const float u2 = u + bilinear(L, t1);
  const float v2 = v + bilinear(L + hw, t1);
  U[p] = round_carry ? round_bf16(u2) : u2;
  U[hw + p] = round_carry ? round_bf16(v2) : v2;

  const Tap t2 = footprint(x, y, u2, v2, H, W, d, clamp);
  const float s = bilinear(nb + (nb_start + b) * hw, t2);
  const float a = acc[i] + s * weight;
  acc[i] = round_carry ? round_bf16(a) : a;
}

template <typename T>
int launch_compose(const T* link, const T* nb, float* flow, float* acc,
                   int B, int H, int W, int link_start, int nb_start,
                   float weight, float d, int clamp, int round_carry,
                   void* stream) {
  const long long total = (long long)B * H * W;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  compose_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      link, nb, flow, acc, H, W, link_start, nb_start, weight, d, clamp,
      round_carry, total);
  return (int)cudaGetLastError();
}

}  // namespace

// One compose tap for B output planes of H x W.  link: (B_link, 2, H, W),
// read at planes link_start .. link_start + B - 1; nb: (B_nb, H, W), read
// at nb_start .. nb_start + B - 1; flow: (B, 2, H, W) and acc: (B, H, W),
// updated in place, their stores rounded to bfloat16 when round_carry is
// set.  All contiguous float32; the caller checks the offset ranges.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int fdt_compose_step(const float* link, const float* nb,
                                float* flow, float* acc, int B, int H, int W,
                                int link_start, int nb_start, float weight,
                                float d, int clamp, int round_carry,
                                void* stream) {
  return launch_compose(link, nb, flow, acc, B, H, W, link_start, nb_start,
                        weight, d, clamp, round_carry, stream);
}

// The packed form: fdt_compose_step with link and nb contiguous bfloat16.
extern "C" int fdt_compose_step_bf16(const __nv_bfloat16* link,
                                     const __nv_bfloat16* nb, float* flow,
                                     float* acc, int B, int H, int W,
                                     int link_start, int nb_start,
                                     float weight, float d, int clamp,
                                     int round_carry, void* stream) {
  return launch_compose(link, nb, flow, acc, B, H, W, link_start, nb_start,
                        weight, d, clamp, round_carry, stream);
}
