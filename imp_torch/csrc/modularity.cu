// The two streaming passes of the graph-modularity loss for Hopper (sm_90a),
// fp32 in and out.
//
// Replaces the Pallas TPU kernels of imp_tpu/ops/modularity.py:
//   * K4 _deg_kernel (:261, launched by _deg_pallas):
//       deg[b,i] = sum_{j != i} relu(x_i . x_j) over slide b's L2-normalised,
//       masked bag x [B,N,D];
//   * K5 _combined_kernel (:135, launched by _pallas_passes): the fused
//     value-and-gradient pass for K = 1 or 2 prototype sets C_k [B,P_k,N]:
//       A = relu(x x^T) with a zero diagonal,  dd = deg deg^T,
//       W/e = (A - dd/e)/e,  best = max_p C[p,i] C[p,j] (first max wins),
//       delta = tanh(best/tau),
//       s1 = sum A*delta,  q = sum delta*dd,
//       dC[p,i] = 2 sum_j (W/e)_ij (1 - delta_ij^2)/tau [argmax_ij = p] C[p,j].
//     The wrapper forms the traces (s1 - q/e)/e; dC is the gradient residual.
//
// What bounds them on the H100: operations. Each pair (i, j) of a slide's
// valid rows costs a D = 256 deep dot product (512 FLOPs) and, for K5, a
// chain of ~50 fp32 operations and one tanh per prototype set, against x
// read once (~10 MB a slide). Every term is symmetric in (i, j), so both
// kernels sweep the upper triangle of 64 x 64 tiles, as the TPU kernels do.
// The products run on the tensor cores in 3xTF32 (tf32x3.cuh: fp32 accuracy
// at a third of the 494.7 TFLOP/s TF32 peak); at UMEML_GAN's training batch
// (two slides of 10 000 and 7 313 rows) that is 0.24 ms of products, where
// the 67 TFLOP/s fp32 cores would need 0.59 ms.
//
// Design (the same sweep for both kernels):
//  * A CTA of 4 warps owns 64 rows I of one slide; each warp owns 16. x_I
//    stays resident in shared memory (rows padded to D + 4 floats); x_J is
//    staged in 32-deep slices, double-buffered by cp.async, so that two CTAs
//    share an SM. Each slice's product is formed apart and added to the
//    tile's accumulator in fp32.
//  * Balance: CTA I sweeps the column tiles J = (I + d) mod nvb for
//    d = 0 ... last_step(I, nvb), a cyclic half sweep of the slide's nvb
//    valid tiles, so every CTA of a slide sweeps within one tile of
//    (nvb + 1) / 2. Launching the longest rows of the plain triangle first
//    cannot do that: row tile 0 alone sweeps all nvb tiles, about twice the
//    average, and it bounds the launch. Tiles past the valid length do no
//    work; a CTA past it writes zeros.
//  * The row side (deg[I], dC[., I]) stays in each lane's registers for the
//    whole sweep and is reduced over the lane quad once, at the end. A tile
//    with J != I also stands for its transpose: its column side (deg[J],
//    dC[., J]) goes to a workspace of partials, one vector of 64 floats per
//    (CTA, step, output vector), packed to the half sweep: ceil(N/64) *
//    floor(ceil(N/64)/2) slots a slide, 3.1 MB per vector at N = 10 000, so
//    ~6 MB for K4 and ~82 MB for K5 (13 vectors) at the training batch. A
//    second launch (deg_reduce_kernel, combined_reduce_kernel) adds, for
//    each column tile, its partials in the fixed order of d to the row side.
//    There are no atomics: two launches on the same input give the same bits.
//  * The diagonal tile counts once in s1 and q, every other tile twice (the
//    TPU kernel's `sym`). s1 and q leave each CTA as one partial per set,
//    summed by the wrapper.
//  * K5 runs its chain in the product's accumulator layout: a lane holds
//    columns 2t, 2t + 1 of rows g and g + 8 of each 8-column block, the C
//    values of its two rows in registers and those of the column tile in
//    shared memory. The argmax keeps the first maximum; C C products are
//    formed as the plain version forms them (row value times column value),
//    which is exact under exchange, so the column side reuses the row side's
//    best, argmax and delta. Its column side is a sum keyed by the argmax:
//    reduced by shuffles over the 8 lanes of a column, it would take 3
//    shuffles for each of P accumulators per lane and column, 1.5 P per
//    pair (19.5 for P = 6 + 7). Here each lane writes its pairs' weighted C
//    value and argmax to a swizzled 64 x 64 tile in shared memory (2 stores
//    per pair), and two threads per column then walk its 64 rows, each
//    adding into half of the P sums (2 loads and P/2 select-adds per pair).
//    K4's column side is a plain sum: 3 shuffles per lane and column.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kChunk = 32;            // depth of one staged slice of x_J
constexpr int kCS = kChunk + kPad;    // its padded row stride
constexpr int kNB = kTile / 8;        // 8-column blocks of a tile
constexpr int kWarps = kThreads / 32;
constexpr int kPMax = 8;              // prototypes per set (the TPU's _P_PAD)
constexpr int kMaxD = 512;            // widest x a resident 64-row tile leaves room for
constexpr int kReduceThreads = 256;   // threads of the column reduction

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// the slots of the column-side workspace per CTA (the longest half sweep
// of a slide with nb tiles, less its diagonal tile)
__host__ __device__ __forceinline__ int half_steps(int nb) { return nb / 2 > 0 ? nb / 2 : 1; }

// the last step d of CTA I's cyclic half sweep over nvb valid tiles. Each
// unordered pair of tiles at distance d < nvb / 2 is swept once, by the CTA
// it lies d ahead of; with nvb even, the pairs at distance nvb / 2 by the
// lower CTA of the two.
__host__ __device__ __forceinline__ int last_step(int I, int nvb) {
  return (nvb - 1) / 2 + ((nvb % 2 == 0 && I < nvb / 2) ? 1 : 0);
}

// rows [row0, row0 + 64) of x [n_rows >= len, D] into a resident tile of row
// stride Dp + kPad; rows at or past len and depth past D are zero
__device__ __forceinline__ void stage_resident(float* xi, const float* xb, int row0, int len, int D,
                                               int Dp) {
  const int C = Dp / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    const bool in = row0 + r < len && 4 * c < D;
    cp_async16(xi + r * (Dp + kPad) + 4 * c, in ? xb + (size_t)(row0 + r) * D + 4 * c : xb, in);
  }
}

// depth slice [k0, k0 + kChunk) of rows [row0, row0 + 64) into a tile of row
// stride kCS, zero as above
__device__ __forceinline__ void stage_slice(float* xj, const float* xb, int row0, int len, int D,
                                            int k0) {
  constexpr int C = kChunk / 4;
#pragma unroll
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const bool in = row0 + r < len && k0 + 4 * c < D;
    cp_async16(xj + r * kCS + 4 * c, in ? xb + (size_t)(row0 + r) * D + k0 + 4 * c : xb, in);
  }
}

// acc += x_I x_J^T over one depth slice for this warp's 16 rows and the
// tile's 64 columns, in 3xTF32; the slice's part is formed apart and added
// in fp32. The A fragments are load_a's, at the resident tile's run-time
// row stride S.
__device__ __forceinline__ void slice_product(const float* xi, int S, int k0, const float* xj,
                                              float (*acc)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* arow = xi + ((threadIdx.x >> 5) * 16 + g) * S + k0 + t;
  float part[kNB][4];
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < kChunk / 8; ++ks) {
    const float* p = arow + ks * 8;
    uint32_t ab[4], as[4];
    split(p[0], ab[0], as[0]);
    split(p[8 * S], ab[1], as[1]);
    split(p[4], ab[2], as[2]);
    split(p[8 * S + 4], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      uint32_t bb[2], bs[2];
      load_b_rows_n<kCS>(xj, j * 8, ks * 8, bb, bs);
      mma3(part[j], ab, as, bb, bs);
    }
  }
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
}

// The cyclic half sweep of row tile I (x_I resident in xi, x_J slices
// double-buffered in xj). `stage(buf, J)` adds a tile's other operands to
// the cp.async group of its first slice (buffer buf = d & 1);
// `tile(d, J, buf, acc)` takes each finished product x_I x_J^T, in the
// accumulator layout, and may change it. Every thread of the CTA calls
// this; the calls of `tile` are uniform over the CTA.
template <class Stage, class Tile>
__device__ __forceinline__ void sweep(const float* xb, float* xi, float* xj, int I, int nvb,
                                      int len, int D, Stage stage, Tile tile) {
  const int Dp = cdiv(D, kChunk) * kChunk, nc = Dp / kChunk;
  const int steps = (last_step(I, nvb) + 1) * nc;
  auto col_tile = [&](int d) { return I + d < nvb ? I + d : I + d - nvb; };
  stage_resident(xi, xb, I * kTile, len, D, Dp);
  stage_slice(xj, xb, col_tile(0) * kTile, len, D, 0);
  stage(0, col_tile(0));
  cp_async_commit();
  float acc[kNB][4];
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  for (int s = 0; s < steps; ++s) {
    const int d = s / nc, c = s - d * nc;
    if (s + 1 < steps) {  // the other buffer was released by the last barrier
      const int d1 = (s + 1) / nc, c1 = s + 1 - d1 * nc;
      stage_slice(xj + ((s + 1) & 1) * kTile * kCS, xb, col_tile(d1) * kTile, len, D,
                  c1 * kChunk);
      if (c1 == 0) stage(d1 & 1, col_tile(d1));
    }
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    slice_product(xi, Dp + kPad, c * kChunk, xj + (s & 1) * kTile * kCS, acc);
    if (c == nc - 1) {
      tile(d, col_tile(d), d & 1, acc);
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      }
    }
    __syncthreads();  // the next stage overwrites this buffer
  }
}

// A = relu(x_I x_J^T) in place, with a zero diagonal on the tile J = I.
// Element e of block j is row 16 warp + g + 8 (e >> 1), column 8 j + 2t + (e & 1).
__device__ __forceinline__ void adjacency(float (*acc)[4], bool diagonal) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool on_diag = diagonal && r0 + 8 * (e >> 1) == j * 8 + 2 * t + (e & 1);
      acc[j][e] = on_diag ? 0.f : fmaxf(acc[j][e], 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// K4: degrees
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 2)
deg_kernel(const float* __restrict__ x, const int* __restrict__ lengths, float* __restrict__ deg,
           float* __restrict__ work, int N, int D) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = cdiv(D, kChunk) * kChunk;
  float* xi = smem;                         // [kTile][Dp + kPad] resident x_I
  float* xj = xi + kTile * (Dp + kPad);     // [2][kTile][kCS] swept x_J slices
  float* colw = xj + 2 * kTile * kCS;       // [kWarps][kTile] column sums per warp

  const int b = blockIdx.y, I = blockIdx.x, nb = gridDim.x, H = half_steps(nb);
  const int len = min(lengths[b], N), nvb = cdiv(len, kTile);
  const float* xb = x + (size_t)b * N * D;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;

  float rows[2] = {0.f, 0.f};  // this lane's part of deg for rows g and g + 8
  if (I < nvb) {  // the same for the whole block
    auto stage = [](int, int) {};
    auto tile = [&](int d, int, int, float(*a)[4]) {
      adjacency(a, d == 0);
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) rows[e >> 1] += a[j][e];
      }
      if (d == 0) return;  // the diagonal tile has no column side
#pragma unroll
      for (int j = 0; j < kNB; ++j) {
        float c0 = a[j][0] + a[j][2], c1 = a[j][1] + a[j][3];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {  // over the 8 lanes g of a column
          c0 += __shfl_xor_sync(0xffffffffu, c0, off);
          c1 += __shfl_xor_sync(0xffffffffu, c1, off);
        }
        if (g == 0) *reinterpret_cast<float2*>(colw + warp * kTile + j * 8 + 2 * t) = make_float2(c0, c1);
      }
      __syncthreads();
      if (threadIdx.x < kTile) {
        const float* cw = colw + threadIdx.x;
        work[(((size_t)b * nb + I) * H + d - 1) * kTile + threadIdx.x] =
            ((cw[0] + cw[kTile]) + cw[2 * kTile]) + cw[3 * kTile];
      }
    };
    sweep(xb, xi, xj, I, nvb, len, D, stage, tile);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = rows[r];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const int row = I * kTile + warp * 16 + g + 8 * r;
    if (t == 0 && row < N) deg[(size_t)b * N + row] = v;
  }
}

// ---------------------------------------------------------------------------
// K5: the combined value-and-gradient pass
// ---------------------------------------------------------------------------

// one prototype set's state in a lane: the C values of its two rows, their
// row-side dC sums, and its parts of s1 and q. P is the set's prototype
// count when known at compile time, else 0 (a run-time count np <= 8).
template <int P>
struct SetRows {
  static constexpr int PU = P > 0 ? P : kPMax;
  float ci[2][PU];
  float dc[2][PU];
  float s1, q;
};

template <int P>
__device__ __forceinline__ void load_rows(SetRows<P>& st, const float* __restrict__ ck, int np,
                                          int b, int N, int len, int row) {
  st.s1 = 0.f;
  st.q = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int p = 0; p < SetRows<P>::PU; ++p) {
      const bool in = row + 8 * r < len && (P > 0 || p < np);
      st.ci[r][p] = in ? ck[((size_t)b * np + p) * N + row + 8 * r] : 0.f;
      st.dc[r][p] = 0.f;
    }
  }
}

// The chain of one set over this warp's 16 x 64 part of a tile, on A in the
// accumulator layout. C of the column tile is cjs [kPMax][kTile], its
// degrees djs. With `col_side`, each pair's column-side term w C[argmax, i]
// and its argmax go to vbuf / kbuf [kTile][kTile] at the swizzled column
// c ^ 8 (row & 7), so that both the stores here and the column walk of
// column_side are free of bank conflicts.
template <int P>
__device__ __forceinline__ void chain_tile(SetRows<P>& st, int np, const float (*a)[4],
                                           const float* cjs, const float* djs,
                                           const float* deg_i, float inv_e, float inv_temp,
                                           float sym, bool col_side, float* vbuf,
                                           uint8_t* kbuf) {
  constexpr int PU = SetRows<P>::PU;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const int col = j * 8 + 2 * t;
    const float2 dj = *reinterpret_cast<const float2*>(djs + col);
    float2 cj[PU];
#pragma unroll
    for (int p = 0; p < PU; ++p) {
      cj[p] = (P > 0 || p < np) ? *reinterpret_cast<const float2*>(cjs + p * kTile + col)
                                : make_float2(0.f, 0.f);
    }
    float v[4];
    int key[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float dd = deg_i[r] * ((e & 1) ? dj.y : dj.x);
      const float amdd = (a[j][e] - dd * inv_e) * inv_e;  // tile of W/e
      float best = st.ci[r][0] * ((e & 1) ? cj[0].y : cj[0].x);
      float best_ci = st.ci[r][0];
      int bp = 0;
#pragma unroll
      for (int p = 1; p < PU; ++p) {
        if (P > 0 || p < np) {
          const float term = st.ci[r][p] * ((e & 1) ? cj[p].y : cj[p].x);
          if (term > best) {  // first max wins, as in the TPU kernel
            best = term;
            best_ci = st.ci[r][p];
            bp = p;
          }
        }
      }
      const float delta = tanhf(best * inv_temp);
      st.s1 = fmaf(sym * a[j][e], delta, st.s1);
      st.q = fmaf(delta, sym * dd, st.q);
      const float w = amdd * ((1.f - delta * delta) * inv_temp);
#pragma unroll
      for (int p = 0; p < PU; ++p) {
        if (p == bp) st.dc[r][p] = fmaf(w, (e & 1) ? cj[p].y : cj[p].x, st.dc[r][p]);
      }
      v[e] = w * best_ci;
      key[e] = bp;
    }
    if (col_side) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int at = (r0 + 8 * r) * kTile + ((j ^ g) << 3) + 2 * t;  // row & 7 == g
        *reinterpret_cast<float2*>(vbuf + at) = make_float2(v[2 * r], v[2 * r + 1]);
        *reinterpret_cast<uint16_t*>(kbuf + at) =
            static_cast<uint16_t>(key[2 * r] | (key[2 * r + 1] << 8));
      }
    }
  }
}

// The column side of one set for a finished tile: thread (c, h) walks the
// 64 rows of column c in order and adds each term to the sum of its argmax,
// for the half h of the set's prototypes; the sums go to dst [np][kTile].
template <int P>
__device__ __forceinline__ void column_side(const float* vbuf, const uint8_t* kbuf, int np,
                                            float* __restrict__ dst) {
  constexpr int HU = ((P > 0 ? P : kPMax) + 1) / 2;
  const int c = threadIdx.x & (kTile - 1), h = threadIdx.x / kTile;
  const int n = P > 0 ? P : np;
  const int lo = h ? n / 2 : 0, hi = h ? n : n / 2;
  float sum[HU];
#pragma unroll
  for (int u = 0; u < HU; ++u) sum[u] = 0.f;
#pragma unroll 8
  for (int r = 0; r < kTile; ++r) {
    const int at = r * kTile + (c ^ ((r & 7) << 3));
    const float v = vbuf[at];
    const int key = kbuf[at];
#pragma unroll
    for (int u = 0; u < HU; ++u) {
      if (key == lo + u) sum[u] += v;
    }
  }
#pragma unroll
  for (int u = 0; u < HU; ++u) {
    if (lo + u < hi) dst[(lo + u) * kTile + c] = sum[u];
  }
}

// the row side of one set: 2 dC, reduced over the lane quad, into dck [B,np,N]
template <int P>
__device__ __forceinline__ void store_rows(const SetRows<P>& st, float* __restrict__ dck, int np,
                                           int b, int N, int row) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int p = 0; p < SetRows<P>::PU; ++p) {
      float v = st.dc[r][p];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((p & 3) == t && row + 8 * r < N && (P > 0 || p < np)) {
        dck[((size_t)b * np + p) * N + row + 8 * r] = 2.f * v;
      }
    }
  }
}

// the block's sums of s1 and q, in a fixed order, into one partial each
template <int P>
__device__ __forceinline__ void store_partials(const SetRows<P>& st, float* red, float* s1_out,
                                               float* q_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float a = st.s1, bq = st.q;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    bq += __shfl_xor_sync(0xffffffffu, bq, off);
  }
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = bq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.f;
    bq = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[w];
      bq += red[kWarps + w];
    }
    *s1_out = a;
    *q_out = bq;
  }
  __syncthreads();  // red is reused by the next set
}

template <int K, int P0, int P1>
__global__ void __launch_bounds__(kThreads, 2)
combined_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                const float* __restrict__ c0, const float* __restrict__ c1,
                const float* __restrict__ deg, const float* __restrict__ inv_e_all,
                float* __restrict__ s1_part, float* __restrict__ q_part,
                float* __restrict__ dc0, float* __restrict__ dc1, float* __restrict__ work,
                int B, int N, int D, int p0_rt, int p1_rt, float inv_temp) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = cdiv(D, kChunk) * kChunk;
  float* xi = smem;                                  // [kTile][Dp + kPad] resident x_I
  float* xj = xi + kTile * (Dp + kPad);              // [2][kTile][kCS] swept x_J slices
  float* cjs = xj + 2 * kTile * kCS;                 // [2][K][kPMax][kTile] C of the column tile
  float* djs = cjs + 2 * K * kPMax * kTile;          // [2][kTile] its degrees
  float* vbuf = djs + 2 * kTile;                     // [kTile][kTile] column-side terms
  float* red = vbuf + kTile * kTile;                 // [2][kWarps]
  uint8_t* kbuf = reinterpret_cast<uint8_t*>(red + 2 * kWarps);  // [kTile][kTile] their argmax

  const int b = blockIdx.y, I = blockIdx.x, nb = gridDim.x, H = half_steps(nb);
  const int len = min(lengths[b], N), nvb = cdiv(len, kTile);
  const float* xb = x + (size_t)b * N * D;
  const float inv_e = inv_e_all[b];
  const int np0 = P0 > 0 ? P0 : p0_rt;
  const int np1 = K == 2 ? (P1 > 0 ? P1 : p1_rt) : 0;
  const int V = np0 + np1;  // output vectors per column-side slot
  const int row = I * kTile + (threadIdx.x >> 5) * 16 + ((threadIdx.x & 31) >> 2);

  SetRows<P0> st0;
  SetRows<P1> st1;
  load_rows(st0, c0, np0, b, N, len, row);
  if constexpr (K == 2) load_rows(st1, c1, np1, b, N, len, row);
  float deg_i[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) deg_i[r] = row + 8 * r < len ? deg[(size_t)b * N + row + 8 * r] : 0.f;

  if (I < nvb) {  // the same for the whole block
    // C of both sets and the degrees of column tile J, zero past len
    auto stage = [&](int buf, int J) {
      float* cb = cjs + buf * K * kPMax * kTile;
      const int col0 = J * kTile;
      for (int i = threadIdx.x; i < V * kTile; i += kThreads) {
        const int v = i / kTile, c = i - v * kTile;
        const int k = v < np0 ? 0 : 1, p = k ? v - np0 : v, np = k ? np1 : np0;
        const float* ck = k ? c1 : c0;
        const bool in = col0 + c < len;
        cp_async4(cb + (k * kPMax + p) * kTile + c, in ? ck + ((size_t)b * np + p) * N + col0 + c : ck,
                  in);
      }
      stage_vec(djs + buf * kTile, deg + (size_t)b * N, col0, len);
    };
    auto tile = [&](int d, int, int buf, float(*a)[4]) {
      adjacency(a, d == 0);
      const float* cb = cjs + buf * K * kPMax * kTile;
      const float* db = djs + buf * kTile;
      const float sym = d > 0 ? 2.f : 1.f;  // an off-diagonal tile stands for two
      float* slot = d > 0 ? work + (((size_t)b * nb + I) * H + d - 1) * V * kTile : nullptr;
      chain_tile(st0, np0, a, cb, db, deg_i, inv_e, inv_temp, sym, d > 0, vbuf, kbuf);
      if (d > 0) {
        __syncthreads();
        column_side<P0>(vbuf, kbuf, np0, slot);
        __syncthreads();  // the next set overwrites vbuf and kbuf
      }
      if constexpr (K == 2) {
        chain_tile(st1, np1, a, cb + kPMax * kTile, db, deg_i, inv_e, inv_temp, sym, d > 0, vbuf,
                   kbuf);
        if (d > 0) {
          __syncthreads();
          column_side<P1>(vbuf, kbuf, np1, slot + np0 * kTile);
          __syncthreads();
        }
      }
    };
    sweep(xb, xi, xj, I, nvb, len, D, stage, tile);
  }

  store_rows(st0, dc0, np0, b, N, row);
  if constexpr (K == 2) store_rows(st1, dc1, np1, b, N, row);
  const size_t part = (size_t)b * nb + I;
  store_partials(st0, red, s1_part + part, q_part + part);
  if constexpr (K == 2) {
    const size_t off = (size_t)B * nb + part;
    store_partials(st1, red, s1_part + off, q_part + off);
  }
}

// ---------------------------------------------------------------------------
// the second launch: column partials into the row side
// ---------------------------------------------------------------------------

// For column tile T of slide b: out[v][T rows] += scale * the column-side
// partials of every CTA that swept T off its diagonal, in the order of d.
// out0 holds vectors 0 .. P0 - 1 as [B,P0,N], out1 the next P1 as [B,P1,N].
// A thread takes 4 columns of one vector (float4 loads) and keeps kUnroll
// slots in flight: the workspace is read once, near the memory rate.
__device__ __forceinline__ void add_column_partials(const int* __restrict__ lengths,
                                                    const float* __restrict__ work, float* out0,
                                                    float* out1, int N, int P0, int P1,
                                                    float scale) {
  constexpr int kQuads = kTile / 4, kUnroll = 8;
  const int b = blockIdx.y, T = blockIdx.x, nb = gridDim.x, H = half_steps(nb);
  const int len = min(lengths[b], N), nvb = cdiv(len, kTile);
  if (T >= nvb) return;  // no valid row: the sweep wrote zeros
  const int V = P0 + P1, dmax = min(H, nvb - 1);
  for (int i = threadIdx.x; i < V * kQuads; i += blockDim.x) {
    const int v = i / kQuads, c = 4 * (i - v * kQuads), row = T * kTile + c;
    float* o = v < P0 ? out0 + ((size_t)b * P0 + v) * N + row
                      : out1 + ((size_t)b * P1 + v - P0) * N + row;
    float sum[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e] = row + e < N ? o[e] : 0.f;
    for (int d0 = 1; d0 <= dmax; d0 += kUnroll) {
      float4 part[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int d = d0 + u, I = T - d < 0 ? T - d + nvb : T - d;
        part[u] = d <= dmax && d <= last_step(I, nvb)
                      ? *reinterpret_cast<const float4*>(
                            work + ((((size_t)b * nb + I) * H + d - 1) * V + v) * kTile + c)
                      : make_float4(0.f, 0.f, 0.f, 0.f);  // adds nothing
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        sum[0] += scale * part[u].x;
        sum[1] += scale * part[u].y;
        sum[2] += scale * part[u].z;
        sum[3] += scale * part[u].w;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (row + e < N) o[e] = sum[e];
    }
  }
}

__global__ void __launch_bounds__(kReduceThreads)
deg_reduce_kernel(const int* __restrict__ lengths, const float* __restrict__ work,
                  float* __restrict__ deg, int N) {
  add_column_partials(lengths, work, deg, deg, N, 1, 0, 1.f);
}

__global__ void __launch_bounds__(kReduceThreads)
combined_reduce_kernel(const int* __restrict__ lengths, const float* __restrict__ work,
                       float* __restrict__ dc0, float* __restrict__ dc1, int N, int P0, int P1) {
  add_column_partials(lengths, work, dc0, dc1, N, P0, P1, 2.f);
}

// dynamic shared memory at feature width D: resident x_I, two x_J slices,
// and K4's column sums per warp (86 016 bytes at D = 256) or K5's column
// operands and column-side tiles (114 240 bytes with K = 2), so that two CTAs
// share an SM
size_t deg_smem_bytes(int D) {
  const int Dp = cdiv(D, kChunk) * kChunk;
  return ((size_t)kTile * (Dp + kPad) + 2 * kTile * kCS + kWarps * kTile) * sizeof(float);
}

size_t combined_smem_bytes(int D, int K) {
  const int Dp = cdiv(D, kChunk) * kChunk;
  return ((size_t)kTile * (Dp + kPad) + 2 * kTile * kCS + 2 * K * kPMax * kTile + 2 * kTile +
          kTile * kTile + 2 * kWarps) * sizeof(float) + kTile * kTile;
}

template <int K, int P0, int P1>
int launch_combined(const float* x, const int* lengths, const float* c0, const float* c1,
                    const float* deg, const float* inv_e, float* s1_part, float* q_part,
                    float* dc0, float* dc1, float* work, int B, int N, int D, int p0, int p1,
                    float inv_temp, cudaStream_t s) {
  const size_t smem = combined_smem_bytes(D, K);
  const int set = allow_smem(combined_kernel<K, P0, P1>, smem);
  if (set) return set;
  const dim3 grid(cdiv(N, kTile), B);
  combined_kernel<K, P0, P1><<<grid, kThreads, smem, s>>>(
      x, lengths, c0, c1, deg, inv_e, s1_part, q_part, dc0, dc1, work, B, N, D, p0, p1, inv_temp);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  combined_reduce_kernel<<<grid, kReduceThreads, 0, s>>>(lengths, work, dc0, dc1, N, p0,
                                                   K == 2 ? p1 : 0);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int B, int N, int D) {
  return B >= 1 && N >= 1 && D >= 4 && D % 4 == 0 && D <= kMaxD;
}

}  // namespace

// x [B,N,D] fp32 contiguous, 16-byte aligned, D % 4 == 0, D <= 512; lengths
// [B] int32 (rows at or past a slide's length are zero in x); deg [B,N] fp32;
// work: the column-side workspace, B * slots * 64 floats (imp_modularity_layout).
// Launches the sweep and the column reduction on `stream`; returns the
// cudaError_t of the shared-memory attribute or of a launch (0 = launched).
extern "C" int imp_modularity_deg_f32(const float* x, const int* lengths, float* deg, float* work,
                                      int B, int N, int D, void* stream) {
  if (!valid_shape(B, N, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = deg_smem_bytes(D);
  const int set = allow_smem(deg_kernel, smem);
  if (set) return set;
  const dim3 grid(cdiv(N, kTile), B);
  deg_kernel<<<grid, kThreads, smem, s>>>(x, lengths, deg, work, N, D);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  deg_reduce_kernel<<<grid, kReduceThreads, 0, s>>>(lengths, work, deg, N);
  return static_cast<int>(cudaGetLastError());
}

// As above, plus K sets (K = 1 or 2) of assignments C_k [B,P_k,N] (P_k in
// 1..8; c1/dc1 unused when K = 1), deg [B,N] from the degree pass, 1/e [B];
// writes dC_k [B,P_k,N] and per-tile partials s1_part, q_part
// [K, B, ceil(N/64)]; work holds B * slots * (P0 + P1) * 64 floats.
extern "C" int imp_modularity_combined_f32(const float* x, const int* lengths,
                                           const float* c0, const float* c1,
                                           const float* deg, const float* inv_e,
                                           float* s1_part, float* q_part,
                                           float* dc0, float* dc1, float* work,
                                           int B, int N, int D, int K, int P0, int P1,
                                           float inv_temp, void* stream) {
  if (!valid_shape(B, N, D) || K < 1 || K > 2 || P0 < 1 || P0 > kPMax ||
      (K == 2 && (P1 < 1 || P1 > kPMax))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 2 && P0 == 6 && P1 == 7) {  // UMEML_GAN: p_proto and h_omic
    return launch_combined<2, 6, 7>(x, lengths, c0, c1, deg, inv_e, s1_part, q_part, dc0, dc1,
                                    work, B, N, D, P0, P1, inv_temp, s);
  }
  if (K == 2) {
    return launch_combined<2, 0, 0>(x, lengths, c0, c1, deg, inv_e, s1_part, q_part, dc0, dc1,
                                    work, B, N, D, P0, P1, inv_temp, s);
  }
  return launch_combined<1, 0, 0>(x, lengths, c0, c0, deg, inv_e, s1_part, q_part, dc0, dc0, work,
                                  B, N, D, P0, P0, inv_temp, s);
}

// The launch layout, for the wrappers and reports: the rows a CTA owns and
// the columns of a swept tile, the column-side slots per slide (each holds
// one 64-float vector per output vector), and the dynamic shared memory of
// K4 and of K5 with K sets at feature width D.
extern "C" int imp_modularity_layout(int N, int D, int K, int* tile, int* slots, int* deg_smem,
                                     int* combined_smem) {
  if (!valid_shape(1, N, D) || K < 1 || K > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = cdiv(N, kTile);
  *tile = kTile;
  *slots = nb * half_steps(nb);
  *deg_smem = static_cast<int>(deg_smem_bytes(D));
  *combined_smem = static_cast<int>(combined_smem_bytes(D, K));
  return 0;
}
