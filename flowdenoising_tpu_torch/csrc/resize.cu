// K-resize: the separable float32 resize of a stack of planes, as a banded
// gather over per-axis tap tables (ops/resize.py: resize_linear,
// resize_area, on a CUDA float32 tensor).
//
// It replaces no TPU kernel: the JAX package resizes with two dense einsums
// (flowdenoising_tpu/ops/resize.py: _apply_separable), and the port with
// two dense batched products a plane, which stay as its plain version.
// Their weight matrices hold at most two nonzeros a row for linear and
// about ceil(in/out) + 1 for area, so a product did O(n^2) work for an
// O(n) function.  K-resize reads, for each output index of an axis, the
// first source index and a fixed-width run of float32 weights (the tap
// table, built on the host from the dense matrix's own float32 entries and
// kept on the card), and computes the dense form's result bit for bit
// wherever the library sums in order (it does at every resize of the
// benchmark's passes; some single planes it splits):
//
// - rows first: for each output row i and source column c, the sum starts
//   from +0.0f and takes fmaf(w, x, sum) over the row taps in ascending
//   source index, as a sequential multiply-add product over the whole
//   column does (a zero weight leaves a finite sum as it was);
// - that result is kept in float32, then the columns the same way.
//
// Two kernels, one launch a resize:
//
// - resize_tile_kernel, two taps on both axes and neither axis smaller
//   (the flow upsamples, most of the bytes): a block owns TILE_R x TILE_C
//   outputs of a plane, stages the source tile they read (at most TILE_R +
//   2 rows by TILE_C + 2 columns) in shared memory with coalesced loads,
//   U of them a thread issued together, then each thread computes its 4 x
//   4 outputs from it, its rows' and columns' taps held in registers.
// - resize_kernel, every other resize (the pyramid's downsamples, the
//   seed's area resize, an axis kept): each thread computes 4 outputs of
//   one column directly from the source, an output (i, j) summing the rows
//   results of its source columns c in turn, each the sum over its row
//   taps; two taps on both axes are unrolled, other tables read at run
//   time.
//
// A rows result shared by neighbouring outputs is recomputed, with the same
// operations, so the bits are the two products'.  A block loops over
// planes; each warp's stores are coalesced along W.  Both are bound by
// bytes: each input read about once, each output written once.
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;            // threads a block: TX columns by TY rows
constexpr int TY = 8;
constexpr int THREADS = TX * TY;
constexpr int TILE_R = 32;        // resize_tile_kernel's outputs a block
constexpr int TILE_C = 128;
constexpr int SR = TILE_R + 2;    // its staged source tile, at most
constexpr int SC = TILE_C + 2;
constexpr int U = 6;              // source loads a thread issues together
constexpr int ROWS = 4;           // output rows a thread (both kernels)
static_assert(TY * ROWS == TILE_R, "a thread's rows cover the tile");

// One axis's tap table: for output index d, source indices start[d] ..
// start[d] + taps - 1 with weights w[d * taps ...].
struct Axis {
  const int* start;
  const float* w;
  int taps;
};

// At most 64 registers, so that four blocks share an SM.
__global__ void __launch_bounds__(THREADS, 4)
resize_tile_kernel(const float* __restrict__ x, float* __restrict__ out,
                   int planes, int H, int W, int H2, int W2, const Axis rows,
                   const Axis cols) {
  constexpr int COLS = TILE_C / TX;   // output columns a thread
  __shared__ float src[SR * SC];
  const int tiles_c = (W2 + TILE_C - 1) / TILE_C;
  const int i0 = (int)(blockIdx.x / tiles_c) * TILE_R;
  const int j0 = (int)(blockIdx.x % tiles_c) * TILE_C;
  const int nr = min(TILE_R, H2 - i0);
  const int nc = min(TILE_C, W2 - j0);
  const int r0 = __ldg(rows.start + i0);
  const int c0 = __ldg(cols.start + j0);
  const int sr = __ldg(rows.start + i0 + nr - 1) + 2 - r0;
  const int sc = __ldg(cols.start + j0 + nc - 1) + 2 - c0;
  const int tid = threadIdx.y * TX + threadIdx.x;
  // this thread's outputs' taps: offsets into the staged tile and weights
  // (an index past the edge takes the last one's and stores nothing)
  int ro[ROWS], co[COLS];
  float rw[ROWS][2], cw[COLS][2];
#pragma unroll
  for (int a = 0; a < ROWS; ++a) {
    const int i = min(i0 + (int)threadIdx.y + TY * a, H2 - 1);
    ro[a] = (__ldg(rows.start + i) - r0) * SC;
    rw[a][0] = __ldg(rows.w + 2 * i);
    rw[a][1] = __ldg(rows.w + 2 * i + 1);
  }
#pragma unroll
  for (int b = 0; b < COLS; ++b) {
    const int j = min(j0 + (int)threadIdx.x + TX * b, W2 - 1);
    co[b] = __ldg(cols.start + j) - c0;
    cw[b][0] = __ldg(cols.w + 2 * j);
    cw[b][1] = __ldg(cols.w + 2 * j + 1);
  }
  // staged element e is source (r0 + e / sc, c0 + e % sc); a thread steps
  // by THREADS elements, dr rows and dc columns
  const int total = sr * sc;
  const int dr = THREADS / sc, dc = THREADS - dr * sc;
  for (long long p = blockIdx.y; p < planes; p += gridDim.y) {
    const float* xp = x + p * H * W + (long long)r0 * W + c0;
    __syncthreads();   // the last plane's tile is read
    int r = tid / sc, c = tid - r * sc;
    for (int e = tid; e < total; e += U * THREADS) {
      float v[U];
      int at[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool ok = e + u * THREADS < total;
        at[u] = ok ? r * SC + c : -1;
        v[u] = ok ? __ldg(xp + (long long)r * W + c) : 0.0f;
        c += dc;
        r += dr;
        if (c >= sc) {
          c -= sc;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (at[u] >= 0) src[at[u]] = v[u];
    }
    __syncthreads();
    float* op = out + p * H2 * W2;
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      const int i = i0 + (int)threadIdx.y + TY * a;
      if (i >= H2) break;
#pragma unroll
      for (int b = 0; b < COLS; ++b) {
        const int j = j0 + (int)threadIdx.x + TX * b;
        const float* s = src + ro[a] + co[b];
        float acc = 0.0f;
#pragma unroll
        for (int kc = 0; kc < 2; ++kc) {
          float rs = 0.0f;
#pragma unroll
          for (int kr = 0; kr < 2; ++kr) rs = fmaf(rw[a][kr], s[kr * SC + kc], rs);
          acc = fmaf(cw[b][kc], rs, acc);
        }
        if (j < W2) op[(long long)i * W2 + j] = acc;
      }
    }
  }
}

// T: taps of both tables (2), or 0 for any number, read at run time.  An
// output's column taps are taken CB at a time: their rows results are
// summed row tap by row tap, each row's CB source values loaded together,
// so that a warp reads each source row it needs in one stretch.
template <int T>
__global__ void __launch_bounds__(THREADS)
resize_kernel(const float* __restrict__ x, float* __restrict__ out,
              int planes, int H, int W, int H2, int W2, const Axis rows,
              const Axis cols) {
  constexpr int CB = T ? T : 8;
  const int rtaps = T ? T : rows.taps;
  const int ctaps = T ? T : cols.taps;
  const int tiles_c = (W2 + TX - 1) / TX;
  const int j = (int)(blockIdx.x % tiles_c) * TX + threadIdx.x;
  const int i0 = (int)(blockIdx.x / tiles_c) * TILE_R + threadIdx.y;
  const int jj = min(j, W2 - 1);
  const int cs = __ldg(cols.start + jj);
  const float* wc = cols.w + (long long)jj * ctaps;
  for (long long p = blockIdx.y; p < planes; p += gridDim.y) {
    const float* xp = x + p * H * W + cs;
    float* op = out + p * H2 * W2 + j;
#pragma unroll
    for (int a = 0; a < ROWS; ++a) {
      const int i = i0 + TY * a;
      if (i >= H2) break;
      const float* s = xp + (long long)__ldg(rows.start + i) * W;
      const float* wr = rows.w + (long long)i * rtaps;
      float acc = 0.0f;
      for (int c0 = 0; c0 < ctaps; c0 += CB) {
        const int nc = min(CB, ctaps - c0);
        float rs[CB];
#pragma unroll
        for (int c = 0; c < CB; ++c) rs[c] = 0.0f;
#pragma unroll 2
        for (int kr = 0; kr < rtaps; ++kr) {
          const float w = __ldg(wr + kr);
          const float* row = s + (long long)kr * W + c0;
#pragma unroll
          for (int c = 0; c < CB; ++c)
            if (c < nc) rs[c] = fmaf(w, __ldg(row + c), rs[c]);
        }
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c < nc) acc = fmaf(__ldg(wc + c0 + c), rs[c], acc);
      }
      if (j < W2) op[(long long)i * W2] = acc;
    }
  }
}

dim3 grid_of(int H2, int W2, int tile_c, int planes) {
  const long long tiles = (long long)((H2 + TILE_R - 1) / TILE_R) *
                          ((W2 + tile_c - 1) / tile_c);
  return dim3((unsigned)tiles, planes < 65535 ? planes : 65535);
}

}  // namespace

// Resize planes of (H, W) to (H2, W2).  x: (planes, H, W) contiguous
// float32; out: (planes, H2, W2) contiguous float32.  rtab / ctab: the row
// and column tap tables on the device, each its axis's n_out int32 start
// indices followed by n_out * taps float32 weights; each start + taps lies
// within its source axis.  One launch on `stream`: resize_tile_kernel where
// both tables have two taps and neither axis shrinks, else resize_kernel;
// returns cudaGetLastError(), or cudaErrorInvalidValue for a table of no
// taps.
extern "C" int fdt_resize(const float* x, float* out, int planes, int H, int W,
                          int H2, int W2, const int* rtab, int rtaps,
                          const int* ctab, int ctaps, void* stream) {
  if (planes == 0 || H2 == 0 || W2 == 0) return (int)cudaSuccess;
  if (rtaps < 1 || ctaps < 1) return (int)cudaErrorInvalidValue;
  const Axis rows = {rtab, reinterpret_cast<const float*>(rtab + H2), rtaps};
  const Axis cols = {ctab, reinterpret_cast<const float*>(ctab + W2), ctaps};
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(TX, TY);
  if (rtaps == 2 && ctaps == 2 && H2 >= H && W2 >= W)
    resize_tile_kernel<<<grid_of(H2, W2, TILE_C, planes), block, 0, s>>>(
        x, out, planes, H, W, H2, W2, rows, cols);
  else if (rtaps == 2 && ctaps == 2)
    resize_kernel<2><<<grid_of(H2, W2, TX, planes), block, 0, s>>>(
        x, out, planes, H, W, H2, W2, rows, cols);
  else
    resize_kernel<0><<<grid_of(H2, W2, TX, planes), block, 0, s>>>(
        x, out, planes, H, W, H2, W2, rows, cols);
  return (int)cudaGetLastError();
}
