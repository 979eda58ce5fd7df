// K-polyexp and K-pyr-blur: the float32 expansion pyramid of a stack of
// planes, the one every pass builds (ops/farneback.py: polyexp_pyramid).
//
// They replace no TPU kernel: the JAX package leaves the pyramid to XLA
// (flowdenoising_tpu/ops/farneback.py: polyexp_pyramid).  The port ran it
// as plain PyTorch chains of ops/blur.py: corr1d -- for each correlation
// a padded copy, an index vector copied from the host, and one multiply
// and one add kernel a tap: some 2,400 device operations a volume, each
// reading and writing a whole stack.  These kernels compute that chain bit
// for bit, and the chain stays as their plain version (ops/farneback.py:
// image_pyramid, then poly_expand):
//
// - the same correlations in the same order, vertical (axis -2) before
//   horizontal (axis -1);
// - each sum starts from the first tap's product and adds each further
//   tap's product in tap order, every product and every sum rounded to
//   float32 (__fmul_rn, __fadd_rn: no multiply-add is contracted, whatever
//   the build);
// - the taps and the inverse-Gram constants are float32, passed by value in
//   the launch's arguments, so nothing is copied to the device first;
// - the combinations in poly_expand's order (b1*ig03 + b5*ig33: two rounded
//   products, then a rounded sum);
// - the borders index as np.pad's "reflect" (OpenCV BORDER_REFLECT_101) and
//   "edge" (BORDER_REPLICATE) do, pads wider than the axis included.
//
// K-polyexp (polyexp_kernel): one level's expansion, (B, H, W) -> (B, 5, H,
// W) channel-first and contiguous, the layout K-umuf reads: three vertical
// correlations (g, xg, xxg: 2n+1 taps, replicate border), six horizontal
// ones and the five combinations.  At level 0 it first applies the level's
// 3-tap reflect-101 pre-blur to the stack it reads; level 0's resize is the
// identity.  K-pyr-blur (pyr_blur_kernel): the pre-blur of a level >= 1,
// the full-resolution stack correlated vertically, then horizontally, and
// written once; ops/resize.py: resize_linear takes it to the level's size,
// and K-polyexp without its blur expands that.
//
// What bounds them on the H100: level 0 reads 4 B and writes 20 B a pixel
// for ~230 float32 operations (without multiply-adds), about the card's
// ratio of operations to bytes, and every operation reads an operand from
// shared memory.  So one block owns a tile of one plane; the tile and its
// halo are read from device memory once and staged in shared memory (the
// blur's result too), the vertical sums never leave shared memory, and in
// the vertical stage each thread sums a strip of RY rows from a window held
// in registers, so a staged value is read once for 3 x RY products.  The
// horizontal stage runs one output a thread with neighbouring threads on
// neighbouring columns: its shared reads are free of bank conflicts and
// its five channel stores are coalesced.  K-pyr-blur is bound by the same
// shared reads; each tap's load is shared by four rows (vertical) or two
// columns (horizontal) of a thread.
//
// K-polyexp is built for the configuration's poly_n, 5; K-pyr-blur for a
// pre-blur whose halo fits a tile in shared memory (up to ~235 taps, levels
// 0-6 at a pyr_scale of 0.5).  Past them the same arithmetic runs through
// device memory, one correlation a launch (pyr_corr_kernel, at most CHUNK
// taps; a longer correlation adds each further chunk to the sums stored by
// the one before it, in tap order), then polyexp_combine_kernel: any
// poly_n, any pre-blur, bit for bit the same chain.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int FUSED_N = 5;        // the poly_n K-polyexp is built for
constexpr int MAX_BLUR_TAPS = 256;
constexpr int SMEM_LIMIT = 232448;   // shared bytes a block may have
constexpr int CHUNK = 512;        // taps a pyr_corr_kernel launch takes
// device planes of scratch the route through device memory uses
constexpr int CORR_PLANES = 9;

// K-polyexp's output tile is TY rows by CW - 2n columns, so that the
// vertical stage's columns (the tile's and a halo of n on each side) are CW:
// TY / RY strips of RY rows by CW columns, one strip a thread.
constexpr int TY = 32;
constexpr int RY = 8;
constexpr int CW = 64;
static_assert(TY / RY * CW == THREADS, "one vertical strip a thread");

struct ExpandArgs {
  float g[2 * FUSED_N + 1], xg[2 * FUSED_N + 1], xxg[2 * FUSED_N + 1];
  float blur[3];
  float ig11, ig03, ig33, ig55;
};

struct BlurArgs {
  float t[MAX_BLUR_TAPS];
};

struct CorrArgs {
  float t[CHUNK];
};

// K-pyr-blur's output tiles (rows, columns), largest first: the first whose
// block fits in shared memory is taken.
constexpr int BLUR_TILES[][2] = {{32, 64}, {16, 64}, {8, 64}, {4, 64},
                                 {4, 32},  {4, 16}, {4, 8},  {4, 4},
                                 {4, 2}};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// np.pad(np.arange(n), (r, r), "reflect")[i + r], for any r.
__device__ __forceinline__ int reflect101(int i, int n) {
  if ((unsigned)i < (unsigned)n) return i;
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - m;
}

// np.pad(np.arange(n), (r, r), "edge")[i + r].
__device__ __forceinline__ int clamp_index(int i, int n) {
  return min(max(i, 0), n - 1);
}

// Shared floats of K-polyexp: region A holds the staged stack, then the
// level image; region B the vertical blur, then the three vertical sums.
constexpr int POLYEXP_SMEM_A = (TY + 2 * FUSED_N + 2) * (CW + 2);
constexpr int POLYEXP_SMEM_B =
    (TY + 2 * FUSED_N) * (CW + 2) > 3 * TY * CW
        ? (TY + 2 * FUSED_N) * (CW + 2) : 3 * TY * CW;

template <bool BLUR>
__global__ void __launch_bounds__(THREADS)
polyexp_kernel(const float* __restrict__ img, float* __restrict__ out, int B,
               int H, int W, const ExpandArgs a) {
  constexpr int N = FUSED_N;
  constexpr int K = 2 * N + 1;
  constexpr int TX = CW - 2 * N;
  extern __shared__ float smem[];
  float* sa = smem;
  float* sb = smem + POLYEXP_SMEM_A;
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * TY;
  const int x0 = blockIdx.x * TX;
  // the rows and columns of the level image that the tile's sums reach
  const int ly0 = max(y0 - N, 0), ly1 = min(y0 + TY - 1 + N, H - 1);
  const int lx0 = max(x0 - N, 0), lx1 = min(x0 + TX - 1 + N, W - 1);
  const int ny = ly1 - ly0 + 1, nx = lx1 - lx0 + 1;
  const size_t plane = (size_t)H * W;

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const float* src = img + (size_t)b * plane;
    if (BLUR) {
      // the stack at rows ly0-1 .. ly1+1 and columns lx0-1 .. lx1+1,
      // reflected; then the blur, vertical into B, horizontal into A
      const int sx = nx + 2;
      for (int i = tid; i < (ny + 2) * sx; i += THREADS) {
        const int r = i / sx, c = i - r * sx;
        sa[i] = src[(size_t)reflect101(ly0 - 1 + r, H) * W +
                    reflect101(lx0 - 1 + c, W)];
      }
      __syncthreads();
      for (int i = tid; i < ny * sx; i += THREADS) {
        const float* p = sa + i;
        float v = mul(p[0], a.blur[0]);
        v = add(v, mul(p[sx], a.blur[1]));
        v = add(v, mul(p[2 * sx], a.blur[2]));
        sb[i] = v;
      }
      __syncthreads();
      for (int i = tid; i < ny * nx; i += THREADS) {
        const int r = i / nx, c = i - r * nx;
        const float* p = sb + r * sx + c;
        float v = mul(p[0], a.blur[0]);
        v = add(v, mul(p[1], a.blur[1]));
        v = add(v, mul(p[2], a.blur[2]));
        sa[i] = v;
      }
    } else {
      for (int i = tid; i < ny * nx; i += THREADS) {
        const int r = i / nx, c = i - r * nx;
        sa[i] = src[(size_t)(ly0 + r) * W + lx0 + c];
      }
    }
    __syncthreads();

    // vertical: the strip's rows ys .. ys+RY-1 at column x0 - n + cv (the
    // edge column where that lies outside the plane), summed over rows
    // clamped into the plane, into B as three TY x CW planes
    {
      const int cv = tid % CW, s = tid / CW;
      const int xc = clamp_index(x0 - N + cv, W) - lx0;
      const int ys = y0 + s * RY;
      float win[RY + 2 * N];
#pragma unroll
      for (int k = 0; k < RY + 2 * N; ++k)
        win[k] = sa[(clamp_index(ys - N + k, H) - ly0) * nx + xc];
      float s0[RY], s1[RY], s2[RY];
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        s0[i] = mul(win[i], a.g[0]);
        s1[i] = mul(win[i], a.xg[0]);
        s2[i] = mul(win[i], a.xxg[0]);
      }
#pragma unroll
      for (int j = 1; j < K; ++j) {
#pragma unroll
        for (int i = 0; i < RY; ++i) {
          s0[i] = add(s0[i], mul(win[i + j], a.g[j]));
          s1[i] = add(s1[i], mul(win[i + j], a.xg[j]));
          s2[i] = add(s2[i], mul(win[i + j], a.xxg[j]));
        }
      }
      float* o = sb + s * RY * CW + cv;
#pragma unroll
      for (int i = 0; i < RY; ++i) {
        o[i * CW] = s0[i];
        o[(TY + i) * CW] = s1[i];
        o[(2 * TY + i) * CW] = s2[i];
      }
    }
    __syncthreads();

    // horizontal, the combinations and the five channels' stores
    for (int i = tid; i < TY * TX; i += THREADS) {
      const int r = i / TX, c = i - r * TX;
      const int y = y0 + r, x = x0 + c;
      if (y >= H || x >= W) continue;
      const float* p0 = sb + r * CW + c;
      const float* p1 = p0 + TY * CW;
      const float* p2 = p1 + TY * CW;
      float b1 = mul(p0[0], a.g[0]);
      float b2 = mul(p0[0], a.xg[0]);
      float b4 = mul(p0[0], a.xxg[0]);
      float b3 = mul(p1[0], a.g[0]);
      float b6 = mul(p1[0], a.xg[0]);
      float b5 = mul(p2[0], a.g[0]);
#pragma unroll
      for (int j = 1; j < K; ++j) {
        const float v0 = p0[j], v1 = p1[j], v2 = p2[j];
        b1 = add(b1, mul(v0, a.g[j]));
        b2 = add(b2, mul(v0, a.xg[j]));
        b4 = add(b4, mul(v0, a.xxg[j]));
        b3 = add(b3, mul(v1, a.g[j]));
        b6 = add(b6, mul(v1, a.xg[j]));
        b5 = add(b5, mul(v2, a.g[j]));
      }
      float* o = out + ((size_t)b * 5 * H + y) * W + x;
      o[0] = mul(b3, a.ig11);
      o[plane] = mul(b2, a.ig11);
      o[2 * plane] = add(mul(b1, a.ig03), mul(b5, a.ig33));
      o[3 * plane] = add(mul(b1, a.ig03), mul(b4, a.ig33));
      o[4 * plane] = mul(b6, a.ig55);
    }
    __syncthreads();
  }
}

// Shared floats of K-pyr-blur for a ty x tx tile and nt taps: the taps,
// the stack's (ty + 2r) x (tx + 2r) window, the vertical sums' ty rows.
long long pyr_blur_floats(int nt, int ty, int tx) {
  const long long r = nt / 2, sx = tx + 2 * r;
  return ((nt + 3) & ~3) + (ty + 2 * r) * sx + ty * sx;
}

__global__ void __launch_bounds__(THREADS)
pyr_blur_kernel(const float* __restrict__ img, float* __restrict__ out, int B,
                int H, int W, int nt, int ty, int tx,
                const __grid_constant__ BlurArgs a) {
  extern __shared__ float smem[];
  const int r = nt / 2;
  const int sx = tx + 2 * r;
  float* st = smem;
  float* si = st + ((nt + 3) & ~3);
  float* sv = si + (ty + 2 * r) * sx;
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * ty;
  const int x0 = blockIdx.x * tx;
  const int qy = ty / 4, hx = tx / 2;
  const size_t plane = (size_t)H * W;
  for (int i = tid; i < nt; i += THREADS) st[i] = a.t[i];

  for (int b = blockIdx.z; b < B; b += gridDim.z) {
    const float* src = img + (size_t)b * plane;
    for (int i = tid; i < (ty + 2 * r) * sx; i += THREADS) {
      const int rr = i / sx, c = i - rr * sx;
      si[i] = src[(size_t)reflect101(y0 - r + rr, H) * W +
                  reflect101(x0 - r + c, W)];
    }
    __syncthreads();
    // vertical: rows rr, rr + ty/4, rr + ty/2, rr + 3ty/4 a thread
    for (int i = tid; i < qy * sx; i += THREADS) {
      const int rr = i / sx, c = i - rr * sx;
      const float* p = si + rr * sx + c;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = mul(p[q * qy * sx], st[0]);
      for (int k = 1; k < nt; ++k) {
        const float t = st[k];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = add(v[q], mul(p[(q * qy + k) * sx], t));
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) sv[(rr + q * qy) * sx + c] = v[q];
    }
    __syncthreads();
    // horizontal: columns c and c + tx/2 a thread, stored
    for (int i = tid; i < ty * hx; i += THREADS) {
      const int rr = i / hx, c = i - rr * hx;
      const int y = y0 + rr, x = x0 + c;
      if (y >= H || x >= W) continue;
      const float* p = sv + rr * sx + c;
      float v0 = mul(p[0], st[0]);
      float v1 = mul(p[hx], st[0]);
      for (int k = 1; k < nt; ++k) {
        const float t = st[k];
        v0 = add(v0, mul(p[k], t));
        v1 = add(v1, mul(p[hx + k], t));
      }
      float* o = out + (size_t)b * plane + (size_t)y * W + x;
      o[0] = v0;
      if (x + hx < W) o[hx] = v1;
    }
    __syncthreads();
  }
}

// One correlation of the route through device memory: taps k0 .. k0+nk-1
// of an nt-tap correlation (r = nt / 2) of each plane of src along its
// rows (along_w) or its columns, with the replicate (edge) or reflect-101
// border; the first chunk (k0 = 0) starts each sum from its first product,
// a later one adds to the sums in dst.
__global__ void __launch_bounds__(THREADS)
pyr_corr_kernel(const float* __restrict__ src, float* dst, int B, int H,
                int W, int along_w, int edge, int r, int k0, int nk,
                const __grid_constant__ CorrArgs a) {
  const size_t total = (size_t)B * H * W;
  const int n = along_w ? W : H;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    const size_t row = i / W;
    const int x = (int)(i - row * W);
    const int y = (int)(row % H);
    const int pos = along_w ? x : y;
    const float* base = along_w ? src + row * W : src + (row - y) * W + x;
    const size_t step = along_w ? 1 : (size_t)W;
    auto at = [&](int k) {
      const int j = pos - r + k0 + k;
      return base[(size_t)(edge ? clamp_index(j, n) : reflect101(j, n)) * step];
    };
    float v = mul(at(0), a.t[0]);
    if (k0) v = add(dst[i], v);
    for (int k = 1; k < nk; ++k) v = add(v, mul(at(k), a.t[k]));
    dst[i] = v;
  }
}

// poly_expand's five combinations of the six horizontal sums, (B, H, W)
// each, into (B, 5, H, W).
__global__ void __launch_bounds__(THREADS)
polyexp_combine_kernel(const float* __restrict__ b1,
                       const float* __restrict__ b2,
                       const float* __restrict__ b3,
                       const float* __restrict__ b4,
                       const float* __restrict__ b5,
                       const float* __restrict__ b6, float* __restrict__ out,
                       int B, int H, int W, float ig11, float ig03,
                       float ig33, float ig55) {
  const size_t plane = (size_t)H * W, total = (size_t)B * plane;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * THREADS) {
    const size_t b = i / plane;
    float* o = out + b * 5 * plane + (i - b * plane);
    o[0] = mul(b3[i], ig11);
    o[plane] = mul(b2[i], ig11);
    o[2 * plane] = add(mul(b1[i], ig03), mul(b5[i], ig33));
    o[3 * plane] = add(mul(b1[i], ig03), mul(b4[i], ig33));
    o[4 * plane] = mul(b6[i], ig55);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

dim3 flat_grid(size_t total) {
  const size_t blocks = (total + THREADS - 1) / THREADS;
  return dim3((unsigned)(blocks < (1u << 20) ? blocks : (1u << 20)));
}

// An nt-tap correlation of src into dst through pyr_corr_kernel, CHUNK taps
// a launch.
cudaError_t correlate(const float* src, float* dst, int B, int H, int W,
                      bool along_w, bool edge, const float* taps, int nt,
                      cudaStream_t stream) {
  const dim3 grid = flat_grid((size_t)B * H * W);
  for (int k0 = 0; k0 < nt; k0 += CHUNK) {
    const int nk = nt - k0 < CHUNK ? nt - k0 : CHUNK;
    CorrArgs a = {};
    for (int k = 0; k < nk; ++k) a.t[k] = taps[k0 + k];
    pyr_corr_kernel<<<grid, THREADS, 0, stream>>>(
        src, dst, B, H, W, along_w, edge, nt / 2, k0, nk, a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// The expansion of poly_n n through device memory: poly_expand's chain, one
// correlation a step, in CORR_PLANES planes of scratch.
int expand_in_memory(const float* img, float* out, float* scratch, int B,
                     int H, int W, int n, const float* taps, int blur,
                     cudaStream_t s) {
  const int k = 2 * n + 1;
  const float *g = taps, *xg = taps + k, *xxg = taps + 2 * k;
  const float* ig = taps + 3 * k + 3;
  const size_t plane = (size_t)B * H * W;
  float* p[CORR_PLANES];
  for (int i = 0; i < CORR_PLANES; ++i) p[i] = scratch + i * plane;
  // the blurred level image in p[1]; the vertical sums in p[2..4]; the
  // horizontal sums b1 .. b6 in p[5..8], p[0] and p[1], free by then
  const float* src = img;
  float *b1 = p[5], *b2 = p[6], *b3 = p[1], *b4 = p[7], *b5 = p[0],
        *b6 = p[8];
  cudaError_t e = cudaSuccess;
  auto corr = [&](const float* a, float* b, bool along_w, bool edge,
                  const float* t, int nt) {
    if (e == cudaSuccess) e = correlate(a, b, B, H, W, along_w, edge, t, nt, s);
  };
  if (blur) {
    corr(img, p[0], false, false, taps + 3 * k, 3);
    corr(p[0], p[1], true, false, taps + 3 * k, 3);
    src = p[1];
  }
  corr(src, p[2], false, true, g, k);
  corr(src, p[3], false, true, xg, k);
  corr(src, p[4], false, true, xxg, k);
  corr(p[2], b1, true, true, g, k);
  corr(p[2], b2, true, true, xg, k);
  corr(p[2], b4, true, true, xxg, k);
  corr(p[3], b3, true, true, g, k);
  corr(p[3], b6, true, true, xg, k);
  corr(p[4], b5, true, true, g, k);
  if (e != cudaSuccess) return (int)e;
  polyexp_combine_kernel<<<flat_grid(plane), THREADS, 0, s>>>(
      b1, b2, b3, b4, b5, b6, out, B, H, W, ig[0], ig[1], ig[2], ig[3]);
  return (int)cudaGetLastError();
}

// The largest of BLUR_TILES whose K-pyr-blur block fits in shared memory
// for nt taps, as {ty, tx}; {0, 0} where none does or nt is past
// MAX_BLUR_TAPS.
void blur_tile(int nt, int tile[2]) {
  tile[0] = tile[1] = 0;
  if (nt > MAX_BLUR_TAPS) return;
  for (const auto& t : BLUR_TILES) {
    if (sizeof(float) * pyr_blur_floats(nt, t[0], t[1]) <= SMEM_LIMIT) {
      tile[0] = t[0];
      tile[1] = t[1];
      return;
    }
  }
}

}  // namespace

// Floats of device scratch fdt_polyexp needs for poly_n n over B planes of
// H x W: none for K-polyexp, CORR_PLANES planes for another n.
extern "C" long long fdt_polyexp_scratch(int n, int B, int H, int W) {
  return n == FUSED_N ? 0 : (long long)CORR_PLANES * B * H * W;
}

// One level's expansion.  img: (B, H, W) contiguous float32; out: (B, 5, H,
// W) contiguous float32; scratch: fdt_polyexp_scratch's floats on the
// device (or none).  taps: host float32 values, g, xg and xxg (2n + 1
// each), the level-0 pre-blur's 3 taps, then ig11, ig03, ig33, ig55; the
// pre-blur runs when `blur` is set.  n = 5 is one launch of K-polyexp;
// another n >= 1 runs through device memory.  Launches on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for n < 1 or scratch
// missing.
extern "C" int fdt_polyexp(const float* img, float* out, float* scratch,
                           int B, int H, int W, int n, const float* taps,
                           int blur, void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n < 1 || (n != FUSED_N && !scratch)) return (int)cudaErrorInvalidValue;
  if (n != FUSED_N)
    return expand_in_memory(img, out, scratch, B, H, W, n, taps, blur, s);
  constexpr int K = 2 * FUSED_N + 1;
  ExpandArgs a = {};
  for (int k = 0; k < K; ++k) {
    a.g[k] = taps[k];
    a.xg[k] = taps[K + k];
    a.xxg[k] = taps[2 * K + k];
  }
  for (int k = 0; k < 3; ++k) a.blur[k] = taps[3 * K + k];
  a.ig11 = taps[3 * K + 3];
  a.ig03 = taps[3 * K + 4];
  a.ig33 = taps[3 * K + 5];
  a.ig55 = taps[3 * K + 6];
  const size_t smem = sizeof(float) * (POLYEXP_SMEM_A + POLYEXP_SMEM_B);
  const dim3 grid((W + CW - 2 * FUSED_N - 1) / (CW - 2 * FUSED_N),
                  (H + TY - 1) / TY, B < 65535 ? B : 65535);
  if (blur)
    polyexp_kernel<true><<<grid, THREADS, smem, s>>>(img, out, B, H, W, a);
  else
    polyexp_kernel<false><<<grid, THREADS, smem, s>>>(img, out, B, H, W, a);
  return (int)cudaGetLastError();
}

// Floats of device scratch fdt_pyr_blur needs for nt taps over B planes of
// H x W: none where a K-pyr-blur tile fits, one plane (the vertical pass)
// where the blur runs through device memory.
extern "C" long long fdt_pyr_blur_scratch(int nt, int B, int H, int W) {
  int tile[2];
  blur_tile(nt, tile);
  return tile[0] ? 0 : (long long)B * H * W;
}

// A level's pre-blur: img, out (B, H, W) contiguous float32; scratch:
// fdt_pyr_blur_scratch's floats on the device (or none); taps: nt host
// float32 values, nt odd.  One launch of K-pyr-blur, on the largest tile
// that fits in shared memory; past that, two passes through device memory.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for an even nt or scratch missing.
extern "C" int fdt_pyr_blur(const float* img, float* out, float* scratch,
                            int B, int H, int W, const float* taps, int nt,
                            void* stream) {
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  if (nt < 1 || nt % 2 == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  int tile[2];
  blur_tile(nt, tile);
  const int ty = tile[0], tx = tile[1];
  if (!ty) {
    if (!scratch) return (int)cudaErrorInvalidValue;
    cudaError_t e = correlate(img, scratch, B, H, W, false, false, taps, nt, s);
    if (e == cudaSuccess)
      e = correlate(scratch, out, B, H, W, true, false, taps, nt, s);
    return (int)e;
  }
  const size_t smem = sizeof(float) * pyr_blur_floats(nt, ty, tx);
  const cudaError_t e = allow_smem(pyr_blur_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  BlurArgs a = {};
  for (int k = 0; k < nt; ++k) a.t[k] = taps[k];
  const dim3 grid((W + tx - 1) / tx, (H + ty - 1) / ty,
                  B < 65535 ? B : 65535);
  pyr_blur_kernel<<<grid, THREADS, smem, s>>>(img, out, B, H, W, nt, ty, tx,
                                              a);
  return (int)cudaGetLastError();
}
