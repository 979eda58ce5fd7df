// K-compose: one tap of the composed-flow pass (--tap_flow compose); and
// K-compose-run (compose_run_kernel below): all taps of a pass in one
// launch, the form the pass runs.
//
// Replaces the Pallas TPU kernel flowdenoising_tpu/ops/pallas/compose.py:
// _compose_kernel (reached through compose_tap_prepped and
// compose_tap_pallas).  The plain PyTorch versions are
// flowdenoising_tpu_torch/ops/cuda/compose.py: compose_tap_plain and
// compose_run_plain.
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

// K-compose-run: a whole compose pass in one launch.  Each thread owns one
// output pixel (b, y, x) and runs both chains of the pass in registers,
// adding into the accumulator in the pass's order: acc[b] (the center tap
// on entry), then the backward run (offsets -1 .. -ks2; link plane ks2-j+b
// of link_bwd, neighbour plane ks2-j+b), then the forward run (+1 .. +ks2;
// link plane ks2+j-1+b of link_fwd, neighbour plane ks2+j+b), each run's
// flow starting from zero.  Each tap is compose_kernel's step, operation
// for operation, so the result equals ks2-long chains of K-compose launches
// bit for bit.  The backward links are read times bwd_sign: -1 with
// symmetric adjacent flows (link_bwd == link_fwd), which stands for the
// negated copy -adj_fwd exactly, since every rounding of the bilinear
// sample is symmetric in sign.  weights[j-1] is tap -j, weights[ks2+j-1]
// tap +j.
//
// What bounds it: with the carry in registers the pass moves each link and
// neighbour plane through device memory once (the gathers of the 2*ks2
// output planes that read a plane hit L2 and L1) and the accumulator once
// each way, ~25 B per output pixel for 2*ks2 steps of ~42 flops: the
// float32 operations bound it, not the bytes.  What it waits on is the
// chain of dependent gathers (the neighbour's address depends on the link
// samples, the next tap's on this one's flow), so for ks2 <= kRunTaps
// (sigma <= 2) the two runs advance side by side, two independent chains a
// thread, and the forward run's weighted samples wait in registers until
// the backward run's are added.  A larger ks2 runs the two chains one after
// the other.  The grid puts the planes in blockIdx.x, so the blocks of
// neighbouring output planes over one 32 x 8 tile run side by side and
// share their link and neighbour reads in L2.
constexpr int kRunTaps = 8;

// One step of a run: the flow (u, v) composed with the link at the current
// flow, kept rounded to bf16 with round_carry; returns the neighbour
// sampled at the new, unrounded flow.
template <typename T>
__device__ __forceinline__ float run_step(const T* link, const T* nb,
                                          long long hw, float sign, float& u,
                                          float& v, int x, int y, int H,
                                          int W, float d, int clamp,
                                          int round_carry) {
  const Tap t1 = footprint(x, y, u, v, H, W, d, clamp);
  const float u2 = u + sign * bilinear(link, t1);
  const float v2 = v + sign * bilinear(link + hw, t1);
  const Tap t2 = footprint(x, y, u2, v2, H, W, d, clamp);
  u = round_carry ? round_bf16(u2) : u2;
  v = round_carry ? round_bf16(v2) : v2;
  return bilinear(nb, t2);
}

__device__ __forceinline__ float add_term(float a, float term,
                                          int round_carry) {
  a = a + term;
  return round_carry ? round_bf16(a) : a;
}

template <typename T>
__global__ void __launch_bounds__(256, 4)
compose_run_kernel(const T* __restrict__ link_bwd,
                   const T* __restrict__ link_fwd, const T* __restrict__ nb,
                   float* __restrict__ acc, const float* __restrict__ weights,
                   int H, int W, int ks2, float bwd_sign, float d, int clamp,
                   int round_carry) {
  const int b = blockIdx.x;
  const int x = blockIdx.z * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const long long hw = (long long)H * W;
  const long long p = (long long)y * W + x;
  // tap -j: link_bwd and nb planes ks2-j+b; tap +j: link_fwd plane
  // ks2+j-1+b, nb plane ks2+j+b
  const T* lb = link_bwd + (long long)(ks2 + b) * 2 * hw;
  const T* lf = link_fwd + (long long)(ks2 - 1 + b) * 2 * hw;
  const T* nc = nb + (long long)(ks2 + b) * hw;
  float a = acc[b * hw + p];
  float ub = 0.0f, vb = 0.0f, uf = 0.0f, vf = 0.0f;
  if (ks2 <= kRunTaps) {
    float fwd_terms[kRunTaps];
#pragma unroll
    for (int j = 1; j <= kRunTaps; ++j) {
      if (j > ks2) break;
      const float sb = run_step(lb - j * 2 * hw, nc - j * hw, hw, bwd_sign,
                                ub, vb, x, y, H, W, d, clamp, round_carry);
      const float sf = run_step(lf + j * 2 * hw, nc + j * hw, hw, 1.0f, uf,
                                vf, x, y, H, W, d, clamp, round_carry);
      a = add_term(a, sb * __ldg(weights + j - 1), round_carry);
      fwd_terms[j - 1] = sf * __ldg(weights + ks2 + j - 1);
    }
#pragma unroll
    for (int j = 1; j <= kRunTaps; ++j) {
      if (j > ks2) break;
      a = add_term(a, fwd_terms[j - 1], round_carry);
    }
  } else {
    for (int j = 1; j <= ks2; ++j) {
      const float s = run_step(lb - j * 2 * hw, nc - j * hw, hw, bwd_sign,
                               ub, vb, x, y, H, W, d, clamp, round_carry);
      a = add_term(a, s * __ldg(weights + j - 1), round_carry);
    }
    for (int j = 1; j <= ks2; ++j) {
      const float s = run_step(lf + j * 2 * hw, nc + j * hw, hw, 1.0f, uf,
                               vf, x, y, H, W, d, clamp, round_carry);
      a = add_term(a, s * __ldg(weights + ks2 + j - 1), round_carry);
    }
  }
  acc[b * hw + p] = a;
}

template <typename T>
int launch_compose_run(const T* link_bwd, const T* link_fwd, const T* nb,
                       float* acc, const float* weights, int n, int H, int W,
                       int ks2, float bwd_sign, float d, int clamp,
                       int round_carry, void* stream) {
  if ((long long)n * H * W == 0 || ks2 == 0) return (int)cudaSuccess;
  const dim3 block(32, 8);
  const dim3 grid(n, (H + block.y - 1) / block.y, (W + block.x - 1) / block.x);
  compose_run_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      link_bwd, link_fwd, nb, acc, weights, H, W, ks2, bwd_sign, d, clamp,
      round_carry);
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

// One compose pass for n output planes of H x W: link_bwd and link_fwd
// (n + 2*ks2 - 1, 2, H, W), the same stack with bwd_sign -1 for symmetric
// adjacent flows; nb (n + 2*ks2, H, W), the padded stack; weights (2*ks2)
// float32 on the device; acc (n, H, W), the center tap on entry, updated in
// place, its steps rounded to bfloat16 when round_carry is set.  All
// contiguous float32; the caller checks the shapes.  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int fdt_compose_run(const float* link_bwd, const float* link_fwd,
                               const float* nb, float* acc,
                               const float* weights, int n, int H, int W,
                               int ks2, float bwd_sign, float d, int clamp,
                               int round_carry, void* stream) {
  return launch_compose_run(link_bwd, link_fwd, nb, acc, weights, n, H, W,
                            ks2, bwd_sign, d, clamp, round_carry, stream);
}

// The packed form: fdt_compose_run with the links and nb contiguous
// bfloat16.
extern "C" int fdt_compose_run_bf16(const __nv_bfloat16* link_bwd,
                                    const __nv_bfloat16* link_fwd,
                                    const __nv_bfloat16* nb, float* acc,
                                    const float* weights, int n, int H, int W,
                                    int ks2, float bwd_sign, float d,
                                    int clamp, int round_carry,
                                    void* stream) {
  return launch_compose_run(link_bwd, link_fwd, nb, acc, weights, n, H, W,
                            ks2, bwd_sign, d, clamp, round_carry, stream);
}
