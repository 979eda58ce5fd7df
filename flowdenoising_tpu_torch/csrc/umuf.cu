// K-umuf: k chained Farneback iterations at one pyramid level in one launch.
//
// Replaces the Pallas TPU kernel flowdenoising_tpu/ops/pallas/umuf.py:
// _umuf_kernel -> _phase1_phase2 (reached through umuf_iterate_prepped).
// The plain PyTorch version is flowdenoising_tpu_torch/ops/farneback.py:
// umuf_iterate_plain, i.e. k times
// update_flow_plain(update_matrices_plain(r0, r1, flow, d), winsize).
//
// Phase 1 (per pixel, strip_m below: the arithmetic of farneback.cuh:
// matrices_from): sample the five channels of the reference expansion r1
// bilinearly at (x + u, y + v), u and v clamped to +-d (no clamp when
// `clamp` is 0), replicate borders; mask out-of-plane samples using the
// UNCLAMPED flow; average the quadratic terms with r0; add the flow terms
// with the unclamped flow; scale by the 5-px border ramp; form M = [G11,
// G12, G22, h1, h2].  Phase 2: box-sum M over (2r+1)^2, r = winsize/2, with
// borders replicating the true edge M; scale by 1/winsize^2; solve the 2x2
// system regularised by +1e-3.
//
// What bounds it on the H100.  The function must read r0 and r1 once and
// read and write the flow once: 56 B per pixel, 0.28 ms at (256, 5, 256,
// 256); its arithmetic (~70 flops of phase 1, 2*(2r+1) adds per channel of
// a separable box sum) is far under the card's float32 rate.  Every
// intermediate stays out of device memory, so the kernel is bound by
// latency: each pixel's r1 taps wait for its flow, and the later
// iterations read r0 and r1 again from L2, so what a thread can keep in
// flight, and how many threads an SM holds, set its pace (PERF.md).  A 2-D
// output tile (the design before this one) also did work twice: it recomputed a
// vertical and a horizontal halo for each of the k fused iterations (1.41x
// phase 1's work at 32x64, k 3, r 2), summed each window column in one
// dependent chain a thread while a quarter of the block waited, and held
// two blocks an SM.
//
// The design: a strip sweep.
// - A block owns TX output columns of one plane and walks down the whole
//   plane in steps of S rows, so no row is computed by two blocks.  The k
//   iterations are k stages of one pipeline: stage j computes M on the
//   strip grown by (k - j) * r columns, clamped to the plane (the window's
//   reach, as the TPU kernel's r*iters context, umuf.py:97-105, but in x
//   only), and its flow feeds stage j + 1.  Phase-1 work falls to 1.06-1.12x
//   the plane's (ops/cuda/umuf.py: StripPlan.phase1_work).
// - M depends only on the flow at its own pixel, so stage j can take row y
//   as soon as stage j - 1 has solved it.  At step t stage j pushes rows
//   L_j = t*S - j*(S + r) .. L_j + S - 1 and emits the vertical window sums
//   of output rows L_j - r ..: it lags S + r rows behind stage j - 1, which
//   emitted those rows one step before.  All stages run at once, so a step
//   is one phase and one barrier, whatever k is.  An output stage solves
//   the rows stage k - 1 emitted the step before and writes the flow to
//   device memory, the only write, once a pixel; stage k - 1's threads,
//   the stage with the least other work, run it in its own columns.
// - One thread a column of each stage (TX + 2(k-j)r threads for stage j)
//   where r is 1-3.  Each keeps its column's last 2r + 1 rows of M in
//   registers, pushes its S rows one at a time, and sums each output row's
//   vertical window afresh over them, top-down.  No thread waits for a
//   column sum of another: the vertical pass has no shared-memory traffic,
//   and the horizontal pass reads 2r + 1 vertical sums a channel per pixel,
//   written by the stage before one step earlier into a buffer of S rows a
//   stage that alternates with the step (so the reads and writes of one
//   step never meet).  Shared memory is those two buffers: 2 * 5 * S floats
//   a stage column, 34.6 KB at TX 64, S 4, k 3, r 2 (the tile took 97 KB).
// - Any other window (r = 0 or r > 3; winsize 1 or 8 and up) lives in a
//   ring of 2r + S rows a column in shared memory, which a team of S
//   threads a column sweeps: each pushes one row of the step, a barrier,
//   then each sums one output row's window.  The planner runs such a
//   window one iteration a launch.  On the H100 (PERF.md) that takes
//   1.07-1.30x the tile's time at winsize 9 and 1.31-1.45x at 15, about
//   the tile's at 21 (5.2x at 15 with one thread a column, k 3 and a
//   division a tap); the window in registers at r 1 and 3 takes 0.88x and
//   0.95x the tile's at the cells' level-0 planes, 1.5x and 2.3x through a
//   ring.
// - Registers set the pace: at most 72 a thread and 224 threads a block, so
//   four blocks an SM.  The window takes 20 of them, so phase 1 (strip_m) is
//   K-umuf's own copy of matrices_from's arithmetic that asks for all of r1's
//   taps and r0's values before it uses any (the compiler would otherwise
//   interleave the loads with the lerps, a round trip to memory a channel),
//   with 32-bit offsets.  Measured and dropped (PERF.md): 8 rows a step (the
//   buffers take the L1 that the lagging stages read r0 and r1 from), 2 rows
//   a step, strips of 32 or 48, up to 128 registers at two or three blocks
//   an SM, two rows' loads in flight at once (spills), the next row's loads
//   ahead of this row's sums, the flows of a step solved before its rows,
//   L2 prefetches of stage 0's rows ahead, per thread or in bulk, and a
//   shared-memory carveout sized to the resident blocks (no change).
// - The plane's edges replicate the true edge M, exactly as the plain
//   version's replicate border: a window row above row 0 or below row H - 1
//   reads row 0 or H - 1 of the column, a window column outside the plane
//   reads the edge column, and a window never crosses an interior strip
//   edge.  The sums run in the plain version's order (ops/blur.py: corr1d
//   along H, then along W, taps in ascending order, each window summed
//   afresh), and with -fmad=false every result equals the plain version's
//   bit for bit, whatever TX, S and k are.
// - The planner in ops/cuda/umuf.py picks TX (the plane's columns in even
//   strips of at most 64), S and k = the level's iterations from (H, W,
//   winsize, iterations).
// - No tensor cores: the only product in the function is the box sum's 0/1
//   band, and TF32 would round M to a 10-bit mantissa, which breaks the bit
//   equality and can miss the JAX package's tolerance.
// - The packed form (K-umuf-bf16, --precision bfloat16: the TPU kernel's
//   `packed` r1, umuf.py:262-263) is this kernel with r1 read as bfloat16
//   (T1 = __nv_bfloat16, bf16.cuh): 46 B per pixel instead of 56, the same
//   plan.  A body that staged r1's window in shared memory by TMA was
//   16-28% slower than the gathers (PERF.md), so r1 stays out of shared
//   memory.  `ramp_bf16` rounds the border ramp to bfloat16, as a bf16
//   pass's tiny levels hold it in the JAX package (farneback.py:
//   update_matrices, `scale` in r0.dtype).
// Built with -fmad=false so the arithmetic rounds as the plain version's
// separate multiplies and adds do.

#include "farneback.cuh"

namespace {

// The widest vertical window (r = winsize / 2) a thread keeps in registers;
// a wider one (or r = 0) lives in a ring in shared memory (the kernel's R =
// -1).  S: the rows a step.  The most threads a block: with the window in
// registers, four blocks an SM at 72 registers a thread; with a ring, two
// at 64.  The planner, ops/cuda/umuf.py, keeps the same four as
// REG_WINDOW_MAX_R, STEP_ROWS, MAX_THREADS and MAX_RING_THREADS.
constexpr int REG_WINDOW_MAX_R = 3;
constexpr int S = 4;
constexpr int MAX_THREADS = 224;
constexpr int MAX_RING_THREADS = 512;

// Columns of stage j < k of a strip TX wide, at most the plane's W: the
// threads of the stage, and the width of its buffer of vertical sums.
__host__ __device__ inline int stage_width(int W, int r, int k, int TX,
                                           int j) {
  return min(TX + 2 * (k - j) * r, W);
}

// Whether the window of r lives in a ring in shared memory (R = -1).
__host__ __device__ inline bool ring_window(int r) {
  return r == 0 || r > REG_WINDOW_MAX_R;
}

// Bytes of one block's shared memory: two buffers of vertical sums (S rows
// of stages 0..k-1), and the rings of M (2r + S rows a column) where the
// window lives in one.
__host__ __device__ inline size_t strip_smem_bytes(int W, int r, int k,
                                                   int TX) {
  size_t cols = 0;
  for (int j = 0; j < k; ++j) cols += stage_width(W, r, k, TX, j);
  const size_t ring = ring_window(r) ? (size_t)5 * (2 * r + S) * cols : 0;
  return sizeof(float) * ((size_t)2 * 5 * S * cols + ring);
}

// Threads of a stage's column: S where the window lives in a ring, one a
// row of a step; else one, which takes the step's rows in turn.
__host__ __device__ inline int team(int r) { return ring_window(r) ? S : 1; }

// Threads of a block: a column's team for every column of every stage but
// the output stage, whose columns stage k - 1's threads take.
__host__ __device__ inline int strip_threads(int W, int r, int k, int TX) {
  int n = 0;
  for (int j = 0; j < k; ++j) n += team(r) * stage_width(W, r, k, TX, j);
  return (n + 31) / 32 * 32;
}

// One batch entry's operands and the level's constants.
template <typename T1>
struct Level {
  const float* R0;
  const T1* R1;
  const float* U;   // the input flow
  const float* V;
  float* Uo;        // the output flow
  float* Vo;
  int H, W;
  int hw;           // H * W: 5 * hw fits an int (the launch checks)
  float d;
  int clamp, ramp_bf16, r;
  float inv_ws2;
};

// Where a stage reads the vertical sums of the stage before: channel c of
// row s at vs[c * cstride + s * width + column - lo], for plane columns
// lo..hi.
struct Sums {
  const float* vs;
  int cstride, width, lo, hi;
};

// The flow at plane column x from row s of the vertical sums `in`: the
// horizontal window sum over columns clamp(x - r + i, lo, hi), i = 0..2r,
// in ascending order, scaled by inv_ws2 (1/winsize^2, not 1/(2r+1)^2: they
// differ for an even winsize), and the 2x2 solve regularised by +1e-3.
// The clamp replicates the plane's edge column; inside the plane the
// window lies within lo..hi.  R >= 0 fixes r at compile time.
template <int R>
__device__ __forceinline__ void solve_at(const Sums& in, int s, int x, int r,
                                         float inv_ws2, float& u, float& v) {
  if constexpr (R >= 0) r = R;
  const float* row = in.vs + s * in.width;
  float a[5];
  const int cf = x - r;
  if (cf >= in.lo && cf + 2 * r <= in.hi) {
    const float* p = row + (cf - in.lo);
#pragma unroll
    for (int c = 0; c < 5; ++c) a[c] = p[c * in.cstride];
#pragma unroll
    for (int i = 1; i < 2 * r + 1; ++i) {
#pragma unroll
      for (int c = 0; c < 5; ++c) a[c] += p[c * in.cstride + i];
    }
  } else {
    const int c0 = clampi(cf, in.lo, in.hi) - in.lo;
#pragma unroll
    for (int c = 0; c < 5; ++c) a[c] = row[c * in.cstride + c0];
    for (int i = 1; i < 2 * r + 1; ++i) {
      const int ci = clampi(cf + i, in.lo, in.hi) - in.lo;
#pragma unroll
      for (int c = 0; c < 5; ++c) a[c] += row[c * in.cstride + ci];
    }
  }
  const float g11 = a[0] * inv_ws2, g12 = a[1] * inv_ws2;
  const float g22 = a[2] * inv_ws2, h1 = a[3] * inv_ws2;
  const float h2 = a[4] * inv_ws2;
  const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
  u = (g11 * h2 - g12 * h1) * idet;
  v = (g22 * h1 - g12 * h2) * idet;
}

// Phase 1 at plane pixel (x, y) with the flow (dx, dy) there: the
// arithmetic of farneback.cuh: matrices_from, op for op, so M is the same
// bit for bit; only the order of the loads differs.  r1's twenty taps and
// r0's five values are all asked for before any of them is used, so that a
// row waits for one round trip to memory rather than one a channel (with
// the window in registers the compiler would otherwise interleave the
// loads with the lerps), and offsets within the entry are 32-bit.
template <typename T1>
__device__ __forceinline__ void strip_m(const Level<T1>& lv, float dx,
                                        float dy, int x, int y, float m[5]) {
  const int H = lv.H, W = lv.W, hw = lv.hw;
  const int p = y * W + x;
  const float fx1 = floorf((float)x + dx);
  const float fy1 = floorf((float)y + dy);
  const bool inb = fx1 >= 0.0f && fx1 <= (float)(W - 2) &&
                   fy1 >= 0.0f && fy1 <= (float)(H - 2);
  float su = dx, sv = dy;
  if (lv.clamp) {
    su = fminf(fmaxf(su, -lv.d), lv.d);
    sv = fminf(fmaxf(sv, -lv.d), lv.d);
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
  const int ra = min(max(y0, 0), H - 1) * W;
  const int rb = min(max(y0 + 1, 0), H - 1) * W;
  float v00[5], v01[5], v10[5], v11[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const T1* q = lv.R1 + c * hw;
    v00[c] = load_f32(q + ra + xa);
    v01[c] = load_f32(q + ra + xb);
    v10[c] = load_f32(q + rb + xa);
    v11[c] = load_f32(q + rb + xb);
  }
  float a[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) a[c] = lv.R0[c * hw + p];
  float s[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float top = v00[c] + (v01[c] - v00[c]) * tx;
    const float bot = v10[c] + (v11[c] - v10[c]) * tx;
    s[c] = top + (bot - top) * ty;
  }
  float r4 = inb ? (a[2] + s[2]) * 0.5f : a[2];
  float r5 = inb ? (a[3] + s[3]) * 0.5f : a[3];
  float r6 = inb ? (a[4] + s[4]) * 0.25f : a[4] * 0.5f;
  float r2 = (a[0] - (inb ? s[0] : 0.0f)) * 0.5f;
  float r3 = (a[1] - (inb ? s[1] : 0.0f)) * 0.5f;
  r2 = r2 + r4 * dy + r6 * dx;
  r3 = r3 + r6 * dy + r5 * dx;
  float sc = (float)(edge_weight(y, H) * edge_weight(x, W));
  if (lv.ramp_bf16) sc = round_bf16(sc);
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

// Phase 1 of stage j at (x, y), row s of the step: M from the level's
// input flow (stage 0) or from the flow the stage before solved in row s
// of its sums.
template <typename T1, int R>
__device__ __forceinline__ void stage_m(const Level<T1>& lv, int j,
                                        const Sums& in, int s, int x, int y,
                                        float m[5]) {
  float dx, dy;
  if (j == 0) {
    const int p = y * lv.W + x;
    dx = lv.U[p];
    dy = lv.V[p];
  } else {
    solve_at<R>(in, s, x, lv.r, lv.inv_ws2, dx, dy);
  }
  strip_m(lv, dx, dy, x, y, m);
}

// One step of stage j (r = R <= REG_WINDOW_MAX_R) in the column of thread
// x: push rows L..L+S-1, one at a time, and write the vertical sums of
// output rows L-R..L-R+S-1 to `out` (channel c of row s at out[(c * S + s)
// * width]).  w holds the column's M at the last 2R + 1 rows pushed, in
// order, carried from step to step: pushing row 0 fills it with row 0's M
// (the rows above the plane replicate it), and a row below H - 1 pushes
// row H - 1's again, until the last output row's window is complete.
template <typename T1, int R>
__device__ __forceinline__ void column_step(const Level<T1>& lv, int j,
                                            const Sums& in, int L, int x,
                                            float* out, int width,
                                            float (&w)[5][2 * R + 1]) {
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    const int y = L + s;
    if (y > lv.H - 1 + R) break;
    if (y >= 0) {
      float m[5];
      if (y < lv.H) {
        stage_m<T1, R>(lv, j, in, s, x, y, m);
      } else {
#pragma unroll
        for (int c = 0; c < 5; ++c) m[c] = w[c][2 * R];
      }
#pragma unroll
      for (int c = 0; c < 5; ++c) {
#pragma unroll
        for (int i = 0; i < 2 * R; ++i) w[c][i] = y == 0 ? m[c] : w[c][i + 1];
        w[c][2 * R] = m[c];
      }
      if (y - R >= 0) {
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          float acc = w[c][0];
#pragma unroll
          for (int i = 1; i < 2 * R + 1; ++i) acc += w[c][i];
          out[(c * S + s) * width] = acc;
        }
      }
    }
  }
}

// column_step for a window wider than REG_WINDOW_MAX_R, in two halves
// with a barrier between: the column's M in a ring of D = 2r + S rows (row
// y at slot y % D, channel c at ring[(c * D + slot) * width]) that the
// column's team of S threads shares, each thread pushing one row of the
// step and then summing one output row's window.  A step writes rows
// L..L+S-1 and its sums read rows L-2r..L+S-1, the D rows the ring holds,
// so a row's slot is row L's plus its distance from L, wrapped once.
__device__ __forceinline__ int ring_slot(int L, int D, int y) {
  const int q = (L % D + D) % D + y - L;
  return q < 0 ? q + D : (q >= D ? q - D : q);
}

// The first half: row L + s of the step into the ring.
template <typename T1>
__device__ __forceinline__ void ring_push(const Level<T1>& lv, int j,
                                          const Sums& in, int L, int s, int x,
                                          int width, float* ring) {
  const int y = L + s, D = 2 * lv.r + S;
  if (y < 0 || y >= lv.H) return;
  float m[5];
  stage_m<T1, -1>(lv, j, in, s, x, y, m);
  float* q = ring + ring_slot(L, D, y) * width;
#pragma unroll
  for (int c = 0; c < 5; ++c) q[c * D * width] = m[c];
}

// The second half: the vertical sums of output row L - r + s, top-down,
// to `out` (channel c of row s at out[(c * S + s) * width]).
__device__ __forceinline__ void ring_sum(int H, int r, int L, int s,
                                         float* out, int width,
                                         const float* ring) {
  const int o = L - r + s, D = 2 * r + S;
  if (o < 0 || o >= H) return;
  const float* q = ring + ring_slot(L, D, clampi(o - r, 0, H - 1)) * width;
  float acc[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) acc[c] = q[c * D * width];
  if (o - r >= 0 && o + r <= H - 1) {
    // the window inside the plane: consecutive slots, wrapped at D
    const float* end = ring + D * width;
    for (int i = 1; i < 2 * r + 1; ++i) {
      q += width;
      if (q == end) q = ring;
#pragma unroll
      for (int c = 0; c < 5; ++c) acc[c] += q[c * D * width];
    }
  } else {
    for (int i = 1; i < 2 * r + 1; ++i) {
      q = ring + ring_slot(L, D, clampi(o - r + i, 0, H - 1)) * width;
#pragma unroll
      for (int c = 0; c < 5; ++c) acc[c] += q[c * D * width];
    }
  }
#pragma unroll
  for (int c = 0; c < 5; ++c) out[(c * S + s) * width] = acc[c];
}

// The output stage's rows L + s0, L + s0 + ds, .. < L + S at plane column
// x: the solve of the sums of stage k - 1 (row s), written to the level's
// output flow.
template <typename T1, int R>
__device__ __forceinline__ void output_rows(const Level<T1>& lv,
                                            const Sums& in, int L, int s0,
                                            int ds, int x) {
#pragma unroll 1
  for (int s = s0; s < S; s += ds) {
    const int y = L + s;
    if (y < 0 || y >= lv.H) continue;
    float u, v;
    solve_at<R>(in, s, x, lv.r, lv.inv_ws2, u, v);
    const int p = y * lv.W + x;
    lv.Uo[p] = u;
    lv.Vo[p] = v;
  }
}

// The strip sweep.  Grid: (strips of TX columns, B); `threads` at least
// strip_threads; shared memory strip_smem_bytes.  R = r when r <=
// REG_WINDOW_MAX_R, else -1 (r at run time, the rings in shared memory,
// a team of S threads a column).  The output stage runs on the threads of
// stage k - 1, the stage with the least other work, in its own columns.
template <typename T1, int R>
__global__ void __launch_bounds__(R >= 0 ? MAX_THREADS : MAX_RING_THREADS,
                                  R >= 0 ? 4 : 2)
umuf_kernel(const float* __restrict__ r0, const T1* __restrict__ r1,
            const float* __restrict__ flow_in, float* __restrict__ flow_out,
            int H, int W, float d, int clamp, int ramp_bf16, int r,
            float inv_ws2, int k, int TX) {
  extern __shared__ float smem[];
  if constexpr (R >= 0) r = R;
  const long long hw = (long long)H * W;
  const long long b = blockIdx.y;
  const Level<T1> lv = {r0 + b * 5 * hw, r1 + b * 5 * hw,
                        flow_in + b * 2 * hw, flow_in + b * 2 * hw + hw,
                        flow_out + b * 2 * hw, flow_out + b * 2 * hw + hw,
                        H, W, H * W, d, clamp, ramp_bf16, r, inv_ws2};
  const int x0 = blockIdx.x * TX, x1 = min(x0 + TX, W) - 1;

  // this thread's stage j < k, its column and its row of a step (the
  // team's), and where the sums of stage j and of stage j - 1 lie in a
  // buffer (floats from the buffer's start)
  constexpr int TEAM = R >= 0 ? 1 : S;
  int j = 0, first = 0, base = 0, width = stage_width(W, r, k, TX, 0);
  int pbase = 0, pwidth = 0;
  while (j + 1 < k && (int)threadIdx.x >= first + TEAM * width) {
    first += TEAM * width;
    pbase = base;
    pwidth = width;
    base += 5 * S * width;
    ++j;
    width = stage_width(W, r, k, TX, j);
  }
  const int lo = max(x0 - (k - j) * r, 0);
  const int hi = min(x1 + (k - j) * r, W - 1);
  const int col = TEAM == 1 ? (int)threadIdx.x - first
                            : ((int)threadIdx.x - first) % width;
  const int row = TEAM == 1 ? 0 : ((int)threadIdx.x - first) / width;
  const int x = lo + col;
  const bool active = row < TEAM && x <= hi;
  // stage k - 1's threads also solve the output columns x0..x1
  const int xo = x0 + col;
  const bool outputs = j == k - 1 && row < TEAM && xo <= x1;
  int buffer = 0;   // floats of one buffer of sums: stages 0..k-1
  for (int i = 0; i < k; ++i) buffer += 5 * S * stage_width(W, r, k, TX, i);
  const Sums prev0 = {nullptr, S * pwidth, pwidth,
                      max(x0 - (k - j + 1) * r, 0),
                      min(x1 + (k - j + 1) * r, W - 1)};
  const Sums own0 = {nullptr, S * width, width, lo, hi};
  float* ring = smem + 2 * buffer + (base / S) * (2 * r + S) + col;

  float w[5][2 * (R > 0 ? R : 0) + 1] = {};
  const int steps = (H + k * (S + r) + S - 1) / S;
  for (int t = 0; t < steps; ++t) {
    const float* old = smem + ((t & 1) ^ 1) * buffer;
    if (outputs) {
      Sums own = own0;
      own.vs = old + base;
      output_rows<T1, R>(lv, own, t * S - k * (S + r), row, TEAM, xo);
    }
    const int L = t * S - j * (S + r);
    const bool live = active && L + S - 1 >= 0 && L - r <= H - 1;
    Sums in = prev0;
    in.vs = old + pbase;
    float* out = smem + (t & 1) * buffer + base + col;
    if constexpr (R >= 0) {
      if (live) column_step<T1, R>(lv, j, in, L, x, out, width, w);
    } else {
      if (live) ring_push<T1>(lv, j, in, L, row, x, width, ring);
      __syncthreads();
      if (live) ring_sum(H, r, L, row, out, width, ring);
    }
    __syncthreads();
  }
}

template <typename T1, int R>
int launch_strip(const float* r0, const T1* r1, const float* flow_in,
                 float* flow_out, int B, int H, int W, float d, int clamp,
                 int ramp_bf16, int r, float inv_ws2, int k, int TX,
                 int threads, size_t smem, cudaStream_t stream) {
  auto kernel = umuf_kernel<T1, R>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + TX - 1) / TX, B);
  kernel<<<grid, threads, smem, stream>>>(r0, r1, flow_in, flow_out, H, W, d,
                                          clamp, ramp_bf16, r, inv_ws2, k, TX);
  return (int)cudaGetLastError();
}

// The launch of fdt_umuf and fdt_umuf_bf16.
template <typename T1>
int launch_umuf(const float* r0, const T1* r1, const float* flow_in,
                float* flow_out, int B, int H, int W, float d, int clamp,
                int ramp_bf16, int winsize, float inv_ws2, int k, int TX,
                int threads, void* stream) {
  if (B == 0 || H == 0 || W == 0 || k == 0) return (int)cudaSuccess;
  const int r = winsize / 2;
  if (k < 0 || TX < 1 || B > 65535 ||
      threads > (ring_window(r) ? MAX_RING_THREADS : MAX_THREADS) ||
      threads < strip_threads(W, r, k, TX) || 5LL * H * W > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = strip_smem_bytes(W, r, k, TX);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define FDT_STRIP(RR)                                                      \
  return launch_strip<T1, RR>(r0, r1, flow_in, flow_out, B, H, W, d, clamp, \
                              ramp_bf16, r, inv_ws2, k, TX, threads, smem, st)
  static_assert(REG_WINDOW_MAX_R == 3, "one case a window in registers");
  switch (ring_window(r) ? -1 : r) {
    case 1: FDT_STRIP(1);
    case 2: FDT_STRIP(2);
    case 3: FDT_STRIP(3);
    default: FDT_STRIP(-1);
  }
#undef FDT_STRIP
}

}  // namespace

// Shared memory of one fdt_umuf block (the planner's formula, for the card
// tests to hold it to): the strip sweep at (W, winsize, k, TX).
extern "C" long long fdt_umuf_strip_smem(int W, int winsize, int k, int TX) {
  return (long long)strip_smem_bytes(W, winsize / 2, k, TX);
}

// Shared memory of one K-umuf-split block (umuf_split.cu), the output tile
// TY x TX that ops/cuda/umuf.py: plan_umuf plans for it.
extern "C" long long fdt_umuf_smem(int H, int W, int winsize, int k, int TY,
                                   int TX) {
  const int r = winsize / 2;
  return (long long)umuf_smem_bytes(min(TY + 2 * k * r, H),
                                    min(TX + 2 * k * r, W), r, k);
}

// k chained iterations in one launch.  r0, r1: (B, 5, H, W); flow_in,
// flow_out: (B, 2, H, W); all contiguous float32, flow_out distinct from
// flow_in.  inv_ws2 is 1/winsize^2 rounded to float32; ramp_bf16 rounds the
// border ramp to bfloat16.  A block sweeps a strip of TX output columns
// down the plane with `threads` threads (at least the columns of its
// stages but the last, at most MAX_THREADS).  Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for a block that does not
// fit the card.
extern "C" int fdt_umuf(const float* r0, const float* r1,
                        const float* flow_in, float* flow_out, int B, int H,
                        int W, float d, int clamp, int ramp_bf16, int winsize,
                        float inv_ws2, int k, int TX, int threads,
                        void* stream) {
  return launch_umuf(r0, r1, flow_in, flow_out, B, H, W, d, clamp, ramp_bf16,
                     winsize, inv_ws2, k, TX, threads, stream);
}

// The packed form: fdt_umuf with r1 contiguous bfloat16.
extern "C" int fdt_umuf_bf16(const float* r0, const __nv_bfloat16* r1,
                             const float* flow_in, float* flow_out, int B,
                             int H, int W, float d, int clamp, int ramp_bf16,
                             int winsize, float inv_ws2, int k, int TX,
                             int threads, void* stream) {
  return launch_umuf(r0, r1, flow_in, flow_out, B, H, W, d, clamp, ramp_bf16,
                     winsize, inv_ws2, k, TX, threads, stream);
}
