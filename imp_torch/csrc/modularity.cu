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
// What bounds them on the H100: operations. Each pair (i, j) costs a D = 256
// deep dot product (512 FLOPs) plus, for K5, ~50 chain operations per set,
// against ~10 MB of x per slide read once: ~0.6 ms of fp32 work per pass at
// the 10 000-token envelope against ~6 us of memory traffic. The fp32
// contract of the tests rules out TF32 and wgmma, so the ceiling is the
// 67 TFLOP/s of the fp32 CUDA cores.
//
// Design (simple and deterministic first):
//  * one block of 256 threads per (slide b, 64-row tile I). The block loops
//    over the 64-column tiles J below the slide's valid length (read from
//    `lengths`) and skips the rest, as pl.when(i < nvb & j < nvb) does. The
//    TPU's sequential grid carried deg, dC, s1 and q across grid steps; here
//    a block owns its rows, so deg and dC need no atomics, and s1/q go to one
//    partial per block that the wrapper sums.
//  * K5 sweeps the FULL square with row ownership (twice the triangle's
//    work): dC[p,i] over all j equals the TPU's row side plus transposed
//    column side. Halving it by symmetry is later work.
//  * the tile product stages 32-deep slices of x_I and x_J in shared memory
//    (transposed, so each thread reads float4 along rows) and each thread
//    keeps a 4 x 4 block of the product in registers, on the fp32 cores.
//  * K5 then writes the A tile to shared memory and runs the per-pair chain
//    with four threads per row (16 columns each); a thread keeps its row's
//    C values, its dC accumulators and its s1/q sums in registers. The
//    argmax loop is unrolled over the actual P (a template parameter on the
//    model's path, P = 6 and 7; a guarded loop up to 8 otherwise).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;      // rows and columns of a tile
constexpr int kChunk = 32;     // depth of one staged slice of the product
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 block of products each
constexpr int kPMax = 8;       // prototypes per set (the TPU's _P_PAD)
constexpr int kWarps = kThreads / 32;

// rows [row0, row0 + 64) x depth [k0, k0 + 32) of x into s[k][row]; rows at or
// past n_rows (the slide's valid length) and depth past D read as zero.
// D is a multiple of 4, so a float4 never straddles the end of a row.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ x, int row0, int n_rows,
                                            int D, int k0, float (*s)[kTile]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // 64 rows x 8 float4 = 512 float4, two per thread
    const int f = threadIdx.x + r * kThreads;
    const int row = f >> 3;
    const int kq = (f & 7) * 4;
    const int grow = row0 + row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (grow < n_rows && k0 + kq < D) {
      v = *reinterpret_cast<const float4*>(x + (size_t)grow * D + k0 + kq);
    }
    s[kq + 0][row] = v.x;
    s[kq + 1][row] = v.y;
    s[kq + 2][row] = v.z;
    s[kq + 3][row] = v.w;
  }
}

// acc[i][j] = x[row0 + 4 ty + i] . x[col0 + 4 tx + j] (zero past n_rows).
// Ends after a __syncthreads, so the caller may reuse shared memory.
__device__ __forceinline__ void tile_product(const float* __restrict__ xb, int row0, int col0,
                                             int n_rows, int D, float (*as)[kTile],
                                             float (*bs)[kTile], float acc[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int k0 = 0; k0 < D; k0 += kChunk) {
    stage_chunk(xb, row0, n_rows, D, k0, as);
    stage_chunk(xb, col0, n_rows, D, k0, bs);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K4: degrees
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
deg_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
           float* __restrict__ deg, int N, int D) {
  __shared__ __align__(16) float as[kChunk][kTile];
  __shared__ __align__(16) float bs[kChunk][kTile];
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kTile;
  const int len = lengths[b];
  const float* xb = x + (size_t)b * N * D;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float rows[4] = {0.f, 0.f, 0.f, 0.f};
  if (row0 < len) {  // the same for the whole block
    for (int col0 = 0; col0 < len; col0 += kTile) {
      float acc[4][4];
      tile_product(xb, row0, col0, len, D, as, bs, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool diag = row0 + ty * 4 + i == col0 + tx * 4 + j;
          rows[i] += diag ? 0.f : fmaxf(acc[i][j], 0.f);
        }
      }
    }
  }
  // the 16 threads of a row group are one half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) rows[i] += __shfl_xor_sync(0xffffffffu, rows[i], off);
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + ty * 4 + i;
      if (r < N) deg[(size_t)b * N + r] = rows[i];
    }
  }
}

// ---------------------------------------------------------------------------
// K5: the combined value-and-gradient pass
// ---------------------------------------------------------------------------

// per-set state of one row: its C values, its dC sums, its s1/q partials
struct SetState {
  float ci[kPMax];
  float dc[kPMax];
  float s1, q;
};

// the per-pair chain of one prototype set, for the row's column c. P is the
// set's prototype count when known at compile time (the loop then unrolls
// over it exactly), else 0 and `np` (<= 8) guards a loop unrolled to 8.
template <int P>
__device__ __forceinline__ void chain(SetState& st, int np, float (*cjk)[kTile], int c,
                                      float a, float dd, float amdd, float inv_temp) {
  constexpr int PU = P > 0 ? P : kPMax;
  float best = st.ci[0] * cjk[0][c];
  float best_c = cjk[0][c];
  int bp = 0;
#pragma unroll
  for (int p = 1; p < PU; ++p) {
    if (P > 0 || p < np) {
      const float cv = cjk[p][c];
      const float term = st.ci[p] * cv;
      if (term > best) {  // first max wins, as in the TPU kernel
        best = term;
        best_c = cv;
        bp = p;
      }
    }
  }
  const float delta = tanhf(best * inv_temp);
  st.s1 = fmaf(a, delta, st.s1);
  st.q = fmaf(delta, dd, st.q);
  const float w = amdd * ((1.f - delta * delta) * inv_temp);
  const float contrib = w * best_c;
#pragma unroll
  for (int p = 0; p < PU; ++p) st.dc[p] += (p == bp) ? contrib : 0.f;
}

__device__ __forceinline__ void load_row(SetState& st, const float* __restrict__ ck, int np,
                                         int b, int N, int gi, bool row_in) {
  st.s1 = 0.f;
  st.q = 0.f;
#pragma unroll
  for (int p = 0; p < kPMax; ++p) {
    st.ci[p] = (row_in && p < np) ? ck[((size_t)b * np + p) * N + gi] : 0.f;
    st.dc[p] = 0.f;
  }
}

__device__ __forceinline__ void store_row(const SetState& st, float* __restrict__ dck, int np,
                                          int b, int N, int gi) {
  // the four threads of a row are four consecutive lanes
#pragma unroll
  for (int p = 0; p < kPMax; ++p) {
    float v = st.dc[p];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if ((threadIdx.x & 3) == 0 && gi < N && p < np) dck[((size_t)b * np + p) * N + gi] = 2.f * v;
  }
}

// the block's sums of s1 and q, in a fixed order, into one partial each
__device__ __forceinline__ void store_partials(const SetState& st, float (*red)[kWarps],
                                              float* s1_out, float* q_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float a = st.s1, bq = st.q;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    bq += __shfl_xor_sync(0xffffffffu, bq, off);
  }
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = bq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = 0.f;
    bq = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      a += red[0][w];
      bq += red[1][w];
    }
    *s1_out = a;
    *q_out = bq;
  }
  __syncthreads();  // red is reused by the next set
}

template <int K, int P0, int P1>
__global__ void __launch_bounds__(kThreads)
combined_kernel(const float* __restrict__ x, const int* __restrict__ lengths,
                const float* __restrict__ c0, const float* __restrict__ c1,
                const float* __restrict__ deg, const float* __restrict__ inv_e_all,
                float* __restrict__ s1_part, float* __restrict__ q_part,
                float* __restrict__ dc0, float* __restrict__ dc1,
                int B, int N, int D, int p0_rt, int p1_rt, float inv_temp) {
  __shared__ __align__(16) float as[kChunk][kTile];
  __shared__ __align__(16) float bs[kChunk][kTile];
  __shared__ float at[kTile][kTile + 1];  // the A tile, row-major
  __shared__ float cj[K][kPMax][kTile];   // C of the column tile
  __shared__ float degj[kTile];
  __shared__ float red[2][kWarps];

  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int row0 = tile * kTile;
  const int len = lengths[b];
  const float* xb = x + (size_t)b * N * D;
  const float inv_e = inv_e_all[b];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int np0 = P0 > 0 ? P0 : p0_rt;
  const int np1 = P1 > 0 ? P1 : p1_rt;

  // chain mapping: four threads per row, 16 consecutive columns each
  const int cr = threadIdx.x >> 2;
  const int cg = (threadIdx.x & 3) * 16;
  const int gi = row0 + cr;
  const bool row_in = gi < len;

  SetState st0, st1;
  load_row(st0, c0, np0, b, N, gi, row_in);
  if (K == 2) load_row(st1, c1, np1, b, N, gi, row_in);
  const float deg_i = row_in ? deg[(size_t)b * N + gi] : 0.f;

  if (row0 < len) {  // the same for the whole block
    for (int col0 = 0; col0 < len; col0 += kTile) {
      float acc[4][4];
      tile_product(xb, row0, col0, len, D, as, bs, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty * 4 + i, c = tx * 4 + j;
          at[r][c] = (row0 + r == col0 + c) ? 0.f : fmaxf(acc[i][j], 0.f);
        }
      }
      for (int t = threadIdx.x; t < kTile; t += kThreads) {
        const int gj = col0 + t;
        degj[t] = gj < len ? deg[(size_t)b * N + gj] : 0.f;
      }
      for (int t = threadIdx.x; t < K * kPMax * kTile; t += kThreads) {
        const int k = t / (kPMax * kTile);
        const int p = (t / kTile) % kPMax;
        const int c = t % kTile;
        const int gj = col0 + c;
        const int np = k == 0 ? np0 : np1;
        const float* ck = k == 0 ? c0 : c1;
        cj[k][p][c] = (p < np && gj < len) ? ck[((size_t)b * np + p) * N + gj] : 0.f;
      }
      __syncthreads();
      if (row_in) {  // diverges only at the slide's last tile
        for (int m = 0; m < 16; ++m) {
          const int c = cg + m;
          const float a = at[cr][c];
          const float dd = deg_i * degj[c];
          const float amdd = (a - dd * inv_e) * inv_e;  // tile of W/e
          chain<P0>(st0, np0, cj[0], c, a, dd, amdd, inv_temp);
          if (K == 2) chain<P1>(st1, np1, cj[K - 1], c, a, dd, amdd, inv_temp);
        }
      }
      __syncthreads();  // the next tile overwrites at, cj and degj
    }
  }

  store_row(st0, dc0, np0, b, N, gi);
  if (K == 2) store_row(st1, dc1, np1, b, N, gi);
  const size_t n_tiles = gridDim.x;
  store_partials(st0, red, s1_part + (size_t)b * n_tiles + tile, q_part + (size_t)b * n_tiles + tile);
  if (K == 2) {
    const size_t off = ((size_t)B + b) * n_tiles + tile;
    store_partials(st1, red, s1_part + off, q_part + off);
  }
}

}  // namespace

// x [B,N,D] fp32 contiguous, 16-byte aligned, D % 4 == 0; lengths [B] int32
// (rows at or past a slide's length are zero in x); deg [B,N] fp32.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int imp_modularity_deg_f32(const float* x, const int* lengths, float* deg,
                                      int B, int N, int D, void* stream) {
  if (B < 1 || N < 1 || D < 4 || D % 4) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + kTile - 1) / kTile, B);
  deg_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, lengths, deg, N, D);
  return static_cast<int>(cudaGetLastError());
}

// As above, plus K sets (K = 1 or 2) of assignments C_k [B,P_k,N] (P_k in
// 1..8; c1/dc1 unused when K = 1), deg [B,N] from the degree pass, 1/e [B];
// writes dC_k [B,P_k,N] and per-tile partials s1_part, q_part
// [K, B, ceil(N/64)].
extern "C" int imp_modularity_combined_f32(const float* x, const int* lengths,
                                           const float* c0, const float* c1,
                                           const float* deg, const float* inv_e,
                                           float* s1_part, float* q_part,
                                           float* dc0, float* dc1,
                                           int B, int N, int D, int K, int P0, int P1,
                                           float inv_temp, void* stream) {
  if (B < 1 || N < 1 || D < 4 || D % 4 || K < 1 || K > 2 || P0 < 1 || P0 > kPMax ||
      (K == 2 && (P1 < 1 || P1 > kPMax))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((N + kTile - 1) / kTile, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 2 && P0 == 6 && P1 == 7) {  // UMEML_GAN: p_proto and h_omic
    combined_kernel<2, 6, 7><<<grid, kThreads, 0, s>>>(
        x, lengths, c0, c1, deg, inv_e, s1_part, q_part, dc0, dc1, B, N, D, P0, P1, inv_temp);
  } else if (K == 2) {
    combined_kernel<2, 0, 0><<<grid, kThreads, 0, s>>>(
        x, lengths, c0, c1, deg, inv_e, s1_part, q_part, dc0, dc1, B, N, D, P0, P1, inv_temp);
  } else {
    combined_kernel<1, 0, 0><<<grid, kThreads, 0, s>>>(
        x, lengths, c0, c0, deg, inv_e, s1_part, q_part, dc0, dc0, B, N, D, P0, P0, inv_temp);
  }
  return static_cast<int>(cudaGetLastError());
}
