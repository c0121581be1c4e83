// The fused Newton-Schulz pseudo-inverse for Hopper (sm_90a), fp32 in and out.
//
// Replaces the Pallas TPU kernels of imp_tpu/ops/pinv_kernel.py:
//   * K6 _fwd_kernel (:73, launched by _fwd_call): for each of g matrices
//     x [m, m], z0 = x^T / c, then `iters` times
//       y = x z,  t1 = 7I - y,  t3 = 15I - y t1,  mm = 13I - y t3,
//       z <- 0.25 z mm
//     (c, the normaliser max(colsums) * max(rowsums), is global over all g
//     matrices and comes in computed);
//   * K7 _bwd_kernel (:83, launched by _bwd_call): replays K6 keeping each
//     iterate z_i, then runs the reverse of each Horner chain by hand:
//       dzi = 0.25 dz mm^T,  dm = 0.25 z_i^T dz,  dy = -dm t3^T,
//       dt2 = y^T dm,  dy += dt2 t1^T,  dt1 = y^T dt2,  dy -= dt1,
//       dx += dy z_i^T,  dz = dzi + x^T dy,
//     and at the end dx += dz^T / c and, per matrix, the normaliser's
//     gradient partial dcp = -sum(x^T . dz) / c^2.
//
// What bounds them on the H100: on paper, operations. K6 is 4 * iters m x m
// products (2 m^3 FLOPs each), K7 4 * (iters - 1) replayed plus 11 * iters
// reverse ones, each depending on the one before; the bytes (x, g_out read
// once, z or dx written once) are a few microseconds at the path's shapes.
// The products run on the tensor cores in 3xTF32 (tf32x3.cuh: fp32 accuracy
// at a third of the 494.7 TFLOP/s TF32 peak; one TF32 pass would not hold
// the 1e-4 gate). In practice the chain of small dependent products decides:
// a CTA's share of one product is 0.5 MFLOP at m = 128, and every product
// reads all of its B operand (4 m^2 bytes) into every CTA of the cluster.
//
// Design:
//  * A thread-block cluster of 8 CTAs per matrix, at every m. CTA r owns row
//    band [r R, (r + 1) R) of every product's output, R = m / 8. Every launch
//    goes through cudaLaunchKernelEx with a cluster attribute; the clusters
//    that fit at once are asked of cudaOccupancyMaxActiveClusters once per
//    device, and a launch is refused when none fits.
//  * The operands live in a per-matrix global workspace (allocated by the
//    wrapper), which stays in L2 at these sizes, and are read through L2
//    (ld.global.cg), so a band written by another SM is never read from a
//    stale L1 line; x is an input and is read through the read-only path.
//    Between dependent products: a fence, then the cluster barrier
//    (barrier.cluster.arrive.release / wait.acquire). Operands kept in the
//    cluster's distributed shared memory instead (each CTA holding its band
//    of every live matrix, peers reading it through map_shared_rank, no
//    fence) left K6 within 10 % and made K7 6-16 % slower at m = 128, and
//    both 1.6-1.7x slower at m = 256 (PERF.md, K6/K7), so there is one
//    route for every m.
//    At m = 256 a cluster of 16 CTAs (16-row bands) fits 7 clusters on the
//    card at once against 15 of 8 CTAs, and was slower too.
//  * A band product streams 16-deep k-slices of both operands through
//    registers (two slices' loads in flight) into two shared buffers; the
//    chain's operand transforms (7I - y, the sign flips, the transposes) are
//    applied on the way in, after the loads have landed. CTA r starts at the
//    slices of its own band and goes round. A warp owns 16 output columns
//    (m / 16 warps at m <= 256; at m >= 384, 8 warps in passes of 128
//    columns); each slice's part is formed in 3xTF32 mma.sync, the three
//    TF32 products in three accumulators, and added in fp32. The epilogue
//    alpha P + diag I (+ E) (+ gamma F) runs on the accumulator layout with
//    the rounding of the TPU kernel's expressions.
//  * No atomics: every output element has one owner, and the dc partials
//    are added in a fixed order (threads, warps, then the cluster's bands by
//    rank 0). Two launches give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kCluster = 8;             // CTAs per matrix
constexpr int kSlice = 16;              // depth of one staged k-slice
constexpr int kSliceS = kSlice + kPad;  // row stride of a row- or n-major slice
constexpr int kPipe = 2;                // k-slices in flight in registers
constexpr int kWarpN = 2;               // 8-column blocks a warp owns
constexpr int kFwdSlots = 5;            // K6: z (two), y, t3, mm
constexpr int kBwdWork = 8;             // K7: y, t3, mm, dm, dt2, dy, dz, tmp
constexpr int kRed = 32;                // floats for the warps' dc partials
constexpr int kDevices = 64;            // devices whose cluster fit is remembered

constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <int M>
struct Shape {
  static constexpr int kR = M / kCluster;      // rows of a band
  static constexpr int kRT = kR / 16;          // m16 row tiles of a band
  static constexpr int kPW = M <= 256 ? M : 128;  // output columns of a pass
  static constexpr int kPasses = M / kPW;
  static constexpr int kWarps = kPW / (8 * kWarpN);
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kSBN = kPW + 8;         // row stride of a k-major B slice
  static constexpr int kSAT = kR + 8;          // row stride of a k-major A slice
  static constexpr int kBufB = cmax(kSlice * kSBN, kPW * kSliceS);
  static constexpr int kBufA = cmax(kR * kSliceS, kSlice * kSAT);
  static constexpr int kBF4 = kSlice * kPW / 4 / kThreads;  // a B slice's float4s a thread
  static constexpr int kAF4 = kR * kSlice / 4;              // an A slice's float4s
  static constexpr size_t kSmem = sizeof(float) * (2 * kBufB + 2 * kBufA + kRed);
  static_assert(kBF4 * kThreads == kSlice * kPW / 4 && kAF4 <= kThreads, "slice split");
  static_assert((M / kSlice) % kPipe == 0 && kPipe % 2 == 0, "pipeline");
};

// A whole m x m matrix in global memory (p is row 0): written by the
// cluster during the launch (read through L2), or an input (read-only).
struct Mat {
  const float* p;
  bool input;
};

// B operand: diag * I + sign * (B or B^T)
struct OpB {
  Mat m;
  float sign, diag;
};

// out = alpha * (A B) + diag * I, then + e, then + gamma * f (e and f are
// read at the element being written, by the thread that writes it; a null
// p means none)
struct Epi {
  Mat out;
  float alpha, diag;
  Mat e, f;
  float gamma;
};

// this CTA's rank in its cluster and the first row of its band
struct Ctx {
  int rank, row0;
};

__device__ __forceinline__ OpB plain(const Mat& m) { return {m, 1.f, 0.f}; }

__device__ __forceinline__ Epi to(const Mat& out, float alpha = 1.f, float diag = 0.f,
                                  const Mat& e = {nullptr, false},
                                  const Mat& f = {nullptr, false}, float gamma = 0.f) {
  return {out, alpha, diag, e, f, gamma};
}

__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}

// Every CTA of the cluster has written its bands of the workspace before
// any reads them, and has read what it needs before any overwrites it.
__device__ __forceinline__ void cluster_sync() {
  __threadfence();
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// row r of a matrix, where the epilogue writes
template <int M>
__device__ __forceinline__ float* row(const Mat& a, int r) {
  return const_cast<float*>(a.p) + (size_t)r * M;
}

// columns [c, c + 4) of row k of a matrix
template <int M>
__device__ __forceinline__ float4 fetch4(const Mat& a, int k, int c) {
  const float4* p = reinterpret_cast<const float4*>(a.p + (size_t)k * M + c);
  return a.input ? __ldg(p) : __ldcg(p);
}

// sign * v + diag at the element e == d of the four (the diagonal's)
__device__ __forceinline__ float4 transform(float4 v, const OpB& B, int d) {
  v.x = fmaf(B.sign, v.x, d == 0 ? B.diag : 0.f);
  v.y = fmaf(B.sign, v.y, d == 1 ? B.diag : 0.f);
  v.z = fmaf(B.sign, v.z, d == 2 ? B.diag : 0.f);
  v.w = fmaf(B.sign, v.w, d == 3 ? B.diag : 0.f);
  return v;
}

// A fragment from a k-major tile (tile[k][r], row stride S): rows [r0, r0 +
// 16), k = [k0, k0 + 8), in load_a's order
template <int S>
__device__ __forceinline__ void load_a_kmajor(const float* tile, int r0, int k0, uint32_t* ab,
                                              uint32_t* as) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (k0 + t) * S + r0 + g;
  split(p[0], ab[0], as[0]);
  split(p[8], ab[1], as[1]);
  split(p[4 * S], ab[2], as[2]);
  split(p[4 * S + 8], ab[3], as[3]);
}

// B fragment from a k-major tile (tile[k][n], row stride S): k = [k0, k0 +
// 8) in load_a's order, n = [n0, n0 + 8)
template <int S>
__device__ __forceinline__ void load_b_kmajor(const float* tile, int k0, int n0, uint32_t* bb,
                                              uint32_t* bs) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (k0 + t) * S + n0 + g;
  split(p[0], bb[0], bs[0]);
  split(p[4 * S], bb[1], bs[1]);
}

// One k-slice of both operands, held in registers: the B slice's float4s
// (kBF4 a thread) and one of the A slice's (threads < kAF4). Layouts in
// shared memory:
//   A: rows [row0, row0 + R) x k, row-major [R][kSliceS]; A^T: k-major
//      [kSlice][kSAT] (columns [row0, row0 + R) of A's rows k);
//   B: k-major [kSlice][kSBN] (columns [c0, c0 + kPW)); B^T: n-major
//      [kPW][kSliceS] (B's rows n in [c0, c0 + kPW), its columns k).
template <int M>
struct Staged {
  float4 b[Shape<M>::kBF4];
  float4 a;
};

// Only loads: what uses the values (the transform, the stores) waits for
// them, so it comes a slice later, in store_slice.
template <int M, bool AT, bool BT>
__device__ __forceinline__ void fetch_slice(const Mat& A, const Mat& B, const Ctx& cx, int k0,
                                            int c0, Staged<M>& st) {
  using S = Shape<M>;
  constexpr int KQ = kSlice / 4, RQ = S::kR / 4;  // float4s of a slice's row, of a band's row
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < S::kBF4; ++i) {
    const int f = tid + i * S::kThreads;
    if (!BT) {
      st.b[i] = fetch4<M>(B, k0 + f / (S::kPW / 4), c0 + 4 * (f % (S::kPW / 4)));
    } else {
      st.b[i] = fetch4<M>(B, c0 + f / KQ, k0 + 4 * (f % KQ));
    }
  }
  if (tid < S::kAF4) {
    if (!AT) {
      st.a = fetch4<M>(A, cx.row0 + tid / KQ, k0 + 4 * (tid % KQ));
    } else {
      st.a = fetch4<M>(A, k0 + tid / RQ, cx.row0 + 4 * (tid % RQ));
    }
  }
}

// the slice fetched for k-slice k0, with B's transform, into shared memory
template <int M, bool AT, bool BT>
__device__ __forceinline__ void store_slice(const Staged<M>& st, const OpB& B, int k0, int c0,
                                            float* sb, float* sa) {
  using S = Shape<M>;
  constexpr int KQ = kSlice / 4, RQ = S::kR / 4;
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < S::kBF4; ++i) {
    const int f = tid + i * S::kThreads;
    if (!BT) {
      const int k = f / (S::kPW / 4), q = 4 * (f % (S::kPW / 4));
      *reinterpret_cast<float4*>(sb + k * S::kSBN + q) = transform(st.b[i], B, k0 + k - (c0 + q));
    } else {
      const int n = f / KQ, q = 4 * (f % KQ);
      *reinterpret_cast<float4*>(sb + n * kSliceS + q) = transform(st.b[i], B, c0 + n - (k0 + q));
    }
  }
  if (tid < S::kAF4) {
    float* p = AT ? sa + (tid / RQ) * S::kSAT + 4 * (tid % RQ)
                  : sa + (tid / KQ) * kSliceS + 4 * (tid % KQ);
    *reinterpret_cast<float4*>(p) = st.a;
  }
}

// acc += this slice's part of the warp's R x 16 output block in 3xTF32: the
// three TF32 products go to three accumulators (three independent chains,
// not one), formed apart and added to acc in fp32, small terms first
template <int M, bool AT, bool BT>
__device__ __forceinline__ void slice_mma(const float* sb, const float* sa,
                                          float (*acc)[kWarpN][4]) {
  using S = Shape<M>;
  const int n0 = (threadIdx.x >> 5) * 8 * kWarpN;
  float pbb[S::kRT][kWarpN][4], pbs[S::kRT][kWarpN][4], psb[S::kRT][kWarpN][4];
#pragma unroll
  for (int rt = 0; rt < S::kRT; ++rt) {
#pragma unroll
    for (int j = 0; j < kWarpN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pbb[rt][j][e] = pbs[rt][j][e] = psb[rt][j][e] = 0.f;
    }
  }
#pragma unroll
  for (int ks = 0; ks < kSlice; ks += 8) {
    uint32_t ab[S::kRT][4], as[S::kRT][4];
#pragma unroll
    for (int rt = 0; rt < S::kRT; ++rt) {
      if (AT) {
        load_a_kmajor<S::kSAT>(sa, rt * 16, ks, ab[rt], as[rt]);
      } else {
        load_a<kSliceS>(sa, rt * 16, ks, ab[rt], as[rt]);
      }
    }
#pragma unroll
    for (int j = 0; j < kWarpN; ++j) {
      uint32_t bb[2], bs[2];
      if (BT) {
        load_b_rows_n<kSliceS>(sb, n0 + 8 * j, ks, bb, bs);
      } else {
        load_b_kmajor<S::kSBN>(sb, ks, n0 + 8 * j, bb, bs);
      }
#pragma unroll
      for (int rt = 0; rt < S::kRT; ++rt) {
        mma_tf32(pbs[rt][j], ab[rt], bs);
        mma_tf32(psb[rt][j], as[rt], bb);
        mma_tf32(pbb[rt][j], ab[rt], bb);
      }
    }
  }
#pragma unroll
  for (int rt = 0; rt < S::kRT; ++rt) {
#pragma unroll
    for (int j = 0; j < kWarpN; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[rt][j][e] += (pbs[rt][j][e] + psb[rt][j][e]) + pbb[rt][j][e];
    }
  }
}

// The accumulator layout: lane (g, t) holds columns 2t, 2t + 1 of rows g
// and g + 8 of each row tile and 8-column block of the warp's block.
template <int M>
__device__ __forceinline__ void epilogue(const Epi& ep, int row0, int c0,
                                         const float (*acc)[kWarpN][4]) {
  using S = Shape<M>;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int rt = 0; rt < S::kRT; ++rt) {
#pragma unroll
    for (int j = 0; j < kWarpN; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = row0 + rt * 16 + g + 8 * h;
        const int c = c0 + (threadIdx.x >> 5) * 8 * kWarpN + 8 * j + 2 * t;
        float v0 = ep.alpha * acc[rt][j][2 * h] + (gr == c ? ep.diag : 0.f);
        float v1 = ep.alpha * acc[rt][j][2 * h + 1] + (gr == c + 1 ? ep.diag : 0.f);
        if (ep.e.p != nullptr) {
          const float2 ev = *reinterpret_cast<const float2*>(row<M>(ep.e, gr) + c);
          v0 = v0 + ev.x;
          v1 = v1 + ev.y;
        }
        if (ep.f.p != nullptr) {
          const float2 fv = *reinterpret_cast<const float2*>(row<M>(ep.f, gr) + c);
          v0 = v0 + ep.gamma * fv.x;
          v1 = v1 + ep.gamma * fv.y;
        }
        *reinterpret_cast<float2*>(row<M>(ep.out, gr) + c) = make_float2(v0, v1);
      }
    }
  }
}

// This CTA's rows of op(A) op(B) into ep. Starts and ends with a barrier of
// the CTA, so the caller may restage and reuse the output. The k-slices
// stream through registers kPipe deep (the loads of slices s + 1 ... s +
// kPipe are in flight while slice s multiplies) into two shared buffers.
// CTA r takes the slices from the band of CTA r on, cyclically.
template <int M, bool AT, bool BT>
__device__ __noinline__ void mul(const Ctx cx, const Mat A, const OpB B, const Epi ep) {
  using S = Shape<M>;
  constexpr int NS = M / kSlice;
  const int first = cx.rank * (S::kR / kSlice);
  // from the shared array itself, not through a pointer argument: so the
  // compiler knows the space and emits shared loads and stores (LDS/STS)
  extern __shared__ __align__(16) float smem[];
  float* sb = smem;
  float* sa = sb + 2 * S::kBufB;
  __syncthreads();
  for (int pass = 0; pass < S::kPasses; ++pass) {
    const int c0 = pass * S::kPW;
    float acc[S::kRT][kWarpN][4];
#pragma unroll
    for (int rt = 0; rt < S::kRT; ++rt) {
#pragma unroll
      for (int j = 0; j < kWarpN; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[rt][j][e] = 0.f;
      }
    }
    Staged<M> st[kPipe];
#pragma unroll
    for (int p = 0; p < kPipe; ++p) {
      fetch_slice<M, AT, BT>(A, B.m, cx, (first + p) % NS * kSlice, c0, st[p]);
    }
    store_slice<M, AT, BT>(st[0], B, first * kSlice, c0, sb, sa);
    __syncthreads();
    for (int s0 = 0; s0 < NS; s0 += kPipe) {
#pragma unroll
      for (int p = 0; p < kPipe; ++p) {
        const int s = s0 + p, cur = p & 1, nxt = cur ^ 1;
        if (s + kPipe < NS) {
          fetch_slice<M, AT, BT>(A, B.m, cx, (first + s + kPipe) % NS * kSlice, c0, st[p]);
        }
        slice_mma<M, AT, BT>(sb + cur * S::kBufB, sa + cur * S::kBufA, acc);
        if (s + 1 < NS) {
          store_slice<M, AT, BT>(st[(p + 1) % kPipe], B, (first + s + 1) % NS * kSlice, c0,
                                 sb + nxt * S::kBufB, sa + nxt * S::kBufA);
        }
        __syncthreads();
      }
    }
    epilogue<M>(ep, cx.row0, c0, acc);
  }
}

// z[row0 + r, j] = x[j, row0 + r] / c over the band
template <int M>
__device__ void transpose_div(const Mat& x, const Mat& z, float c, int row0) {
  using S = Shape<M>;
  constexpr int Q = S::kR / 4;
  for (int f = threadIdx.x; f < M * Q; f += S::kThreads) {
    const int j = f / Q, r = row0 + 4 * (f % Q);
    const float4 v = fetch4<M>(x, j, r);
    row<M>(z, r + 0)[j] = v.x / c;
    row<M>(z, r + 1)[j] = v.y / c;
    row<M>(z, r + 2)[j] = v.z / c;
    row<M>(z, r + 3)[j] = v.w / c;
  }
}

// the band's rows of one Newton-Schulz step: y = x z, t3 = 15I - y (7I - y),
// mm = 13I - y t3, zn = 0.25 z mm; z complete on entry
template <int M>
__device__ void ns_step(const Ctx& cx, const Mat& x, const Mat& z, const Mat& zn, const Mat& y,
                        const Mat& t3, const Mat& mm) {
  mul<M, false, false>(cx, x, plain(z), to(y));
  cluster_sync();
  mul<M, false, false>(cx, y, {y, -1.f, 7.f}, to(t3, -1.f, 15.f));
  cluster_sync();
  mul<M, false, false>(cx, y, plain(t3), to(mm, -1.f, 13.f));
  cluster_sync();
  mul<M, false, false>(cx, z, plain(mm), to(zn, 0.25f));
}

template <int M>
__global__ void __launch_bounds__(Shape<M>::kThreads)
pinv_fwd_kernel(const float* __restrict__ x_all, const float* __restrict__ c_ptr,
                float* __restrict__ z_all, float* __restrict__ ws_all, int iters) {
  const size_t mat = cluster_id(), mm2 = (size_t)M * M;
  const int rank = cluster_rank();
  const Ctx cx = {rank, rank * Shape<M>::kR};
  auto slot = [&](int i) -> Mat { return {ws_all + (mat * kFwdSlots + i) * mm2, false}; };
  const Mat x = {x_all + mat * mm2, true}, out = {z_all + mat * mm2, false};
  const float c = *c_ptr;

  transpose_div<M>(x, slot(0), c, cx.row0);
  for (int it = 0; it < iters; ++it) {
    cluster_sync();  // z complete, and the last step's reads of y, t3, mm done
    ns_step<M>(cx, x, slot(it & 1), it + 1 == iters ? out : slot((it + 1) & 1), slot(2), slot(3),
               slot(4));
  }
}

template <int M>
__global__ void __launch_bounds__(Shape<M>::kThreads)
pinv_bwd_kernel(const float* __restrict__ x_all, const float* __restrict__ c_ptr,
                const float* __restrict__ g_all, float* __restrict__ dx_all,
                float* __restrict__ dcp, float* __restrict__ ws_all, int iters) {
  using S = Shape<M>;
  extern __shared__ __align__(16) float smem[];
  const size_t mat = cluster_id(), mm2 = (size_t)M * M;
  const int rank = cluster_rank(), row0 = rank * S::kR;
  const Ctx cx = {rank, row0};
  float* red = smem + 2 * S::kBufB + 2 * S::kBufA;
  // ws [g, 8 + iters, m, m]: the work, then every z_i
  float* ws = ws_all + mat * (kBwdWork + iters) * mm2;
  auto work = [&](int i) -> Mat { return {ws + i * mm2, false}; };
  auto zi = [&](int i) -> Mat { return {ws + (kBwdWork + i) * mm2, false}; };
  const Mat y = work(0), t3 = work(1), mm = work(2), dm = work(3), dt2 = work(4), dy = work(5),
            dz = work(6), tmp = work(7);
  const Mat x = {x_all + mat * mm2, true}, dx = {dx_all + mat * mm2, false};
  const Mat none = {nullptr, false};
  const float c = *c_ptr;

  // forward replay, keeping every z_i
  transpose_div<M>(x, zi(0), c, row0);
  for (int i = 0; i + 1 < iters; ++i) {
    cluster_sync();
    ns_step<M>(cx, x, zi(i), zi(i + 1), y, t3, mm);
  }
  for (int f = threadIdx.x; f < S::kR * (M / 4); f += S::kThreads) {  // dz = g_out, this band
    const int r = row0 + f / (M / 4), q = 4 * (f % (M / 4));
    *reinterpret_cast<float4*>(row<M>(dz, r) + q) =
        __ldg(reinterpret_cast<const float4*>(g_all + mat * mm2 + (size_t)r * M + q));
  }

  // reverse sweep
  for (int i = iters - 1; i >= 0; --i) {
    const Mat z = zi(i);
    cluster_sync();  // z_i and dz complete, the last step's reads done
    mul<M, false, false>(cx, x, plain(z), to(y));
    mul<M, true, false>(cx, z, plain(dz), to(dm, 0.25f));
    cluster_sync();
    mul<M, false, false>(cx, y, {y, -1.f, 7.f}, to(t3, -1.f, 15.f));
    mul<M, true, false>(cx, y, plain(dm), to(dt2));  // dt2 = -dt3 = y^T dm
    cluster_sync();
    mul<M, false, false>(cx, y, plain(t3), to(mm, -1.f, 13.f));
    mul<M, true, false>(cx, y, plain(dt2), to(tmp));  // dt1
    mul<M, false, true>(cx, dm, plain(t3), to(dy, -1.f));  // dt4 t3^T
    // dy = (dy + dt2 t1^T) - dt1, t1^T = 7I - y^T
    mul<M, false, true>(cx, dt2, {y, -1.f, 7.f}, to(dy, 1.f, 0.f, dy, tmp, -1.f));
    cluster_sync();
    mul<M, false, true>(cx, dz, plain(mm), to(tmp, 0.25f));  // dzi
    mul<M, false, true>(cx, dy, plain(z), to(dx, 1.f, 0.f, i == iters - 1 ? none : dx));
    mul<M, true, false>(cx, x, plain(dy), to(dz, 1.f, 0.f, tmp));
  }
  cluster_sync();  // dz complete

  // z_0 = x^T / c: dx += dz^T / c, and this band's part of sum(x^T . dz)
  constexpr int Q = S::kR / 4;
  float acc = 0.f;
  for (int f = threadIdx.x; f < M * Q; f += S::kThreads) {
    const int j = f / Q, r = row0 + 4 * (f % Q);
    const float4 dzt = fetch4<M>(dz, j, r);  // dz[j, r ...]
    const float4 xt = fetch4<M>(x, j, r);
    const float dzv[4] = {dzt.x, dzt.y, dzt.z, dzt.w}, xv[4] = {xt.x, xt.y, xt.z, xt.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float* d = row<M>(dx, r + e) + j;
      *d = *d + dzv[e] / c;
      acc += xv[e] * row<M>(dz, r + e)[j];
    }
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  float* part = const_cast<float*>(tmp.p);  // free now: the bands' partials
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int w = 0; w < S::kWarps; ++w) sum += red[w];
    part[rank] = sum;
  }
  cluster_sync();
  if (rank == 0 && threadIdx.x == 0) {
    float total = 0.f;
    for (int r = 0; r < kCluster; ++r) total += __ldcg(part + r);
    dcp[mat] = -total / (c * c);
  }
}

// floats of ws per matrix
template <int M>
int ws_floats(bool bwd, int iters) {
  return (bwd ? kBwdWork + iters : kFwdSlots) * M * M;
}

// one cluster of 8 CTAs per matrix
template <int M>
cudaLaunchConfig_t config(int g, cudaStream_t st, cudaLaunchAttribute& attr) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g * kCluster);
  cfg.blockDim = dim3(Shape<M>::kThreads);
  cfg.dynamicSmemBytes = Shape<M>::kSmem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Set the kernel's shared memory (an attribute of the current device:
// before every launch) and count its clusters that fit on the device at
// once, asked of the CUDA runtime once per device.
template <int M, typename Kernel>
int prepare(Kernel kernel, int& clusters) {
  static int known[kDevices];  // 0: not asked yet, else clusters + 1
  int err = allow_smem(kernel, Shape<M>::kSmem);
  int dev = 0;
  if (!err) err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev < kDevices && known[dev]) {
    clusters = known[dev] - 1;
    return 0;
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<M>(1, nullptr, attr);
  err = static_cast<int>(cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg));
  if (!err && dev < kDevices) known[dev] = clusters + 1;
  return err;
}

// launch, or refuse when no cluster fits on the card
template <int M, typename Kernel, typename... Args>
int launch(Kernel kernel, int g, cudaStream_t st, Args... args) {
  int clusters = 0;
  int err = prepare<M>(kernel, clusters);
  if (err) return err;
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<M>(g, st, attr);
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
  return err ? err : static_cast<int>(cudaGetLastError());
}

template <int M>
int launch_fwd(const float* x, const float* c, float* z, float* ws, int g, int iters,
               cudaStream_t st) {
  return launch<M>(pinv_fwd_kernel<M>, g, st, x, c, z, ws, iters);
}

template <int M>
int launch_bwd(const float* x, const float* c, const float* g_out, float* dx, float* dcp,
               float* ws, int g, int iters, cudaStream_t st) {
  return launch<M>(pinv_bwd_kernel<M>, g, st, x, c, g_out, dx, dcp, ws, iters);
}

template <int M>
int layout(int iters, int* cluster, int* threads, int* fwd_smem, int* bwd_smem, int* fwd_ws,
           int* bwd_ws, int* fwd_clusters, int* bwd_clusters) {
  *cluster = kCluster;
  *threads = Shape<M>::kThreads;
  *fwd_smem = *bwd_smem = static_cast<int>(Shape<M>::kSmem);
  *fwd_ws = ws_floats<M>(false, iters);
  *bwd_ws = ws_floats<M>(true, iters);
  int err = prepare<M>(pinv_fwd_kernel<M>, *fwd_clusters);
  return err ? err : prepare<M>(pinv_bwd_kernel<M>, *bwd_clusters);
}

bool bad_shape(int g, int m, int iters) {
  return g < 1 || iters < 1 || (m != 128 && m != 256 && m != 384 && m != 512);
}

}  // namespace

// x, z [g, m, m] fp32 contiguous, 16-byte aligned, m in {128, 256, 384, 512};
// c one fp32 on the card; ws scratch of g * fwd_ws floats (imp_pinv_layout).
// Launches on `stream`; returns the cudaError_t of an attribute, of the
// launch, or cudaErrorInvalidConfiguration when no cluster fits on the card
// (0 = launched).
extern "C" int imp_pinv_fwd_f32(const float* x, const float* c, float* z, float* ws, int g, int m,
                                int iters, void* stream) {
  if (bad_shape(g, m, iters)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 128: return launch_fwd<128>(x, c, z, ws, g, iters, st);
    case 256: return launch_fwd<256>(x, c, z, ws, g, iters, st);
    case 384: return launch_fwd<384>(x, c, z, ws, g, iters, st);
    default: return launch_fwd<512>(x, c, z, ws, g, iters, st);
  }
}

// As above, plus g_out [g, m, m] (the cotangent of z); writes dx [g, m, m]
// and dcp [g], one normaliser-gradient partial per matrix; ws is scratch of
// g * bwd_ws floats (imp_pinv_layout).
extern "C" int imp_pinv_bwd_f32(const float* x, const float* c, const float* g_out, float* dx,
                                float* dcp, float* ws, int g, int m, int iters, void* stream) {
  if (bad_shape(g, m, iters)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 128: return launch_bwd<128>(x, c, g_out, dx, dcp, ws, g, iters, st);
    case 256: return launch_bwd<256>(x, c, g_out, dx, dcp, ws, g, iters, st);
    case 384: return launch_bwd<384>(x, c, g_out, dx, dcp, ws, g, iters, st);
    default: return launch_bwd<512>(x, c, g_out, dx, dcp, ws, g, iters, st);
  }
}

// The launch layout at size m, for the wrappers and reports: CTAs per
// cluster (one cluster per matrix) and threads per CTA, each kernel's
// dynamic shared memory in bytes and scratch in floats per matrix, and how
// many of its clusters fit on the current device at once.
extern "C" int imp_pinv_layout(int m, int iters, int* cluster, int* threads, int* fwd_smem,
                               int* bwd_smem, int* fwd_ws, int* bwd_ws, int* fwd_clusters,
                               int* bwd_clusters) {
  if (bad_shape(1, m, iters)) return static_cast<int>(cudaErrorInvalidValue);
  switch (m) {
    case 128:
      return layout<128>(iters, cluster, threads, fwd_smem, bwd_smem, fwd_ws, bwd_ws,
                         fwd_clusters, bwd_clusters);
    case 256:
      return layout<256>(iters, cluster, threads, fwd_smem, bwd_smem, fwd_ws, bwd_ws,
                         fwd_clusters, bwd_clusters);
    case 384:
      return layout<384>(iters, cluster, threads, fwd_smem, bwd_smem, fwd_ws, bwd_ws,
                         fwd_clusters, bwd_clusters);
    default:
      return layout<512>(iters, cluster, threads, fwd_smem, bwd_smem, fwd_ws, bwd_ws,
                         fwd_clusters, bwd_clusters);
  }
}
