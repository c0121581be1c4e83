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
//   Every product is true fp32 on the CUDA cores: the iteration diverges in
//   TF32, so wgmma (bf16/TF32 operands) is not used.
//
// What bounds them on the H100: operations. K6 is 4 * iters m x m products
// (2 m^3 FLOPs each), K7 4 * (iters - 1) replayed plus 11 * iters reverse
// ones; the bytes (x, g_out read once, z or dx written once) are a few
// microseconds at the shapes of the path.
//
// Design (simple and right first):
//  * one matrix is too large for one SM (a 256 x 256 fp32 matrix is 256 KB
//    against 227 KB of shared memory, and the chain needs x, z, y, t3, mm at
//    once), and one CTA per matrix would run g = 8 ... 128 CTAs on 132 SMs.
//    So each matrix gets a thread-block cluster of 8 CTAs; CTA r of the
//    cluster owns row band [r m/8, (r + 1) m/8) of every product's output.
//  * the operands live in a per-matrix global workspace (allocated by the
//    wrapper), which stays in L2 at these sizes. A band product reads its A
//    operand's own band (or, transposed, a column band) and all of B.
//  * between dependent products the cluster synchronises: a fence, then the
//    cluster barrier (release/acquire), and every operand read goes through
//    L2 (ld.global.cg), so a band written by another SM is never read from
//    a stale L1 line. A band that only its own CTA reads needs no barrier.
//  * a band product stages 32-deep slices of A (k-major) and of a 128-column
//    slice of B in shared memory; each of the 8 warps owns m/64 rows of the
//    band, each lane 4 columns, summing over k in order with fmaf. The
//    operand transforms of the chain (7I - y) are applied while staging, the
//    epilogue forms alpha P + diag I (+ E) (+ gamma F) with the same rounding
//    as the TPU kernel's expressions.
//  * no atomics: every output element has one owner, and the dc partial of
//    each band is summed in a fixed order (threads, warps, then the cluster's
//    8 bands by rank 0).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;    // CTAs per matrix
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunkK = 32;    // depth of one staged slice
constexpr int kChunkN = 128;   // output columns per pass of a band product
constexpr int kMaxBand = 64;   // band rows at m = 512

struct Smem {
  float a[kChunkK][kMaxBand + 4];  // A slice, k-major: a[k][r]
  float b[kChunkK][kChunkN + 4];   // B slice: b[k][c]
  float red[kWarps];
};

// A operand: p or, with t, p^T ([m, m] row-major)
struct OpA {
  const float* p;
  bool t;
};

// B operand: diag * I + sign * (p or p^T)
struct OpB {
  const float* p;
  bool t;
  float sign, diag;
};

// out = alpha * (A B) + diag * I, then + e, then + gamma * f (e and f are
// read at the element being written, so they may alias out)
struct Epi {
  float* out;
  float alpha, diag;
  const float* e;
  const float* f;
  float gamma;
};

__device__ __forceinline__ OpB plain(const float* p, bool t = false) { return {p, t, 1.f, 0.f}; }

__device__ __forceinline__ Epi to(float* out, float alpha = 1.f, float diag = 0.f,
                                  const float* e = nullptr, const float* f = nullptr,
                                  float gamma = 0.f) {
  return {out, alpha, diag, e, f, gamma};
}

__device__ __forceinline__ unsigned cluster_index() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// every CTA of the cluster has written its bands before any reads them
__device__ __forceinline__ void cluster_sync() {
  __threadfence();
  cg::this_cluster().sync();
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}

// s.a[k][r] = opA[row0 + r, k0 + k] for r < R
template <int R>
__device__ __forceinline__ void stage_a(const OpA& A, int m, int row0, int k0, Smem& s) {
  if (!A.t) {
    for (int f = threadIdx.x; f < R * (kChunkK / 4); f += kThreads) {
      const int r = f / (kChunkK / 4), kq = (f % (kChunkK / 4)) * 4;
      const float4 v = ld4(A.p + (size_t)(row0 + r) * m + k0 + kq);
      s.a[kq + 0][r] = v.x;
      s.a[kq + 1][r] = v.y;
      s.a[kq + 2][r] = v.z;
      s.a[kq + 3][r] = v.w;
    }
  } else {
    for (int f = threadIdx.x; f < kChunkK * (R / 4); f += kThreads) {
      const int k = f / (R / 4), rq = (f % (R / 4)) * 4;
      *reinterpret_cast<float4*>(&s.a[k][rq]) = ld4(A.p + (size_t)(k0 + k) * m + row0 + rq);
    }
  }
}

// s.b[k][c] = opB[k0 + k, c0 + c] for c < 128
__device__ __forceinline__ void stage_b(const OpB& B, int m, int k0, int c0, Smem& s) {
  if (!B.t) {
    for (int f = threadIdx.x; f < kChunkK * (kChunkN / 4); f += kThreads) {
      const int k = f / (kChunkN / 4), cq = (f % (kChunkN / 4)) * 4;
      float4 v = ld4(B.p + (size_t)(k0 + k) * m + c0 + cq);
      const int d = (k0 + k) - (c0 + cq);  // the diagonal's column in this float4
      v.x = fmaf(B.sign, v.x, d == 0 ? B.diag : 0.f);
      v.y = fmaf(B.sign, v.y, d == 1 ? B.diag : 0.f);
      v.z = fmaf(B.sign, v.z, d == 2 ? B.diag : 0.f);
      v.w = fmaf(B.sign, v.w, d == 3 ? B.diag : 0.f);
      *reinterpret_cast<float4*>(&s.b[k][cq]) = v;
    }
  } else {
    for (int f = threadIdx.x; f < kChunkK * (kChunkN / 4); f += kThreads) {
      const int c = f / (kChunkK / 4), kq = (f % (kChunkK / 4)) * 4;
      const float4 v = ld4(B.p + (size_t)(c0 + c) * m + k0 + kq);
      const int d = (c0 + c) - (k0 + kq);  // the diagonal's row in this float4
      s.b[kq + 0][c] = fmaf(B.sign, v.x, d == 0 ? B.diag : 0.f);
      s.b[kq + 1][c] = fmaf(B.sign, v.y, d == 1 ? B.diag : 0.f);
      s.b[kq + 2][c] = fmaf(B.sign, v.z, d == 2 ? B.diag : 0.f);
      s.b[kq + 3][c] = fmaf(B.sign, v.w, d == 3 ? B.diag : 0.f);
    }
  }
}

// Rows [row0, row0 + 8 TM) of opA @ opB into ep. Warp w owns band rows
// [w TM, (w + 1) TM), lane l columns [c0 + 4 l, c0 + 4 l + 4) of each
// 128-column pass. Ends after a __syncthreads, so the caller may restage.
template <int TM>
__device__ void band_product(const OpA& A, const OpB& B, const Epi& ep, int m, int row0,
                             Smem& s) {
  constexpr int R = TM * kWarps;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int c0 = 0; c0 < m; c0 += kChunkN) {
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < m; k0 += kChunkK) {
      stage_a<R>(A, m, row0, k0, s);
      stage_b(B, m, k0, c0, s);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kChunkK; ++k) {
        const float4 b = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = s.a[k][ty * TM + i];  // one address per warp: a broadcast
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int gr = row0 + ty * TM + i, gc = c0 + tx * 4;
      const size_t off = (size_t)gr * m + gc;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = ep.alpha * acc[i][j] + (gr == gc + j ? ep.diag : 0.f);
      if (ep.e != nullptr) {
        const float4 e = ld4(ep.e + off);
        v[0] = v[0] + e.x;
        v[1] = v[1] + e.y;
        v[2] = v[2] + e.z;
        v[3] = v[3] + e.w;
      }
      if (ep.f != nullptr) {
        const float4 f = ld4(ep.f + off);
        v[0] = v[0] + ep.gamma * f.x;
        v[1] = v[1] + ep.gamma * f.y;
        v[2] = v[2] + ep.gamma * f.z;
        v[3] = v[3] + ep.gamma * f.w;
      }
      *reinterpret_cast<float4*>(ep.out + off) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// z[row0 + r, j] = x[j, row0 + r] / c over the band
__device__ __forceinline__ void transpose_div(const float* x, float* z, int m, int row0, int R,
                                              float c) {
  for (int f = threadIdx.x; f < R * m; f += kThreads) {
    const int r = row0 + f / m, j = f % m;
    z[(size_t)r * m + j] = __ldcg(x + (size_t)j * m + r) / c;
  }
}

// the band's rows of one Newton-Schulz step: y = x z, t3 = 15I - y (7I - y),
// mm = 13I - y t3 and, when zn is given, zn = 0.25 z mm; z complete on entry
template <int TM>
__device__ __forceinline__ void ns_step(const float* x, const float* z, float* zn, float* y,
                                        float* t3, float* mm, int m, int row0, Smem& s) {
  band_product<TM>({x, false}, plain(z), to(y), m, row0, s);
  cluster_sync();
  band_product<TM>({y, false}, {y, false, -1.f, 7.f}, to(t3, -1.f, 15.f), m, row0, s);
  cluster_sync();
  band_product<TM>({y, false}, plain(t3), to(mm, -1.f, 13.f), m, row0, s);
  if (zn != nullptr) {
    cluster_sync();
    band_product<TM>({z, false}, plain(mm), to(zn, 0.25f), m, row0, s);
  }
}

template <int TM>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
pinv_fwd_kernel(const float* __restrict__ x_all, const float* __restrict__ c_ptr,
                float* __restrict__ z_all, float* __restrict__ ws_all, int m, int iters) {
  __shared__ __align__(16) Smem s;
  constexpr int R = TM * kWarps;
  const size_t mat = cluster_index(), mm2 = (size_t)m * m;
  const int row0 = static_cast<int>(cg::this_cluster().block_rank()) * R;
  const float* x = x_all + mat * mm2;
  float* ws = ws_all + mat * 4 * mm2;
  // z_i lives in zbuf[(iters - i) & 1], so z_iters lands in the output
  float* zbuf[2] = {z_all + mat * mm2, ws};
  float* y = ws + mm2;
  float* t3 = ws + 2 * mm2;
  float* mm = ws + 3 * mm2;
  const float c = *c_ptr;

  float* z = zbuf[iters & 1];
  transpose_div(x, z, m, row0, R, c);
  for (int it = 0; it < iters; ++it) {
    float* zn = zbuf[(iters - it - 1) & 1];
    cluster_sync();
    ns_step<TM>(x, z, zn, y, t3, mm, m, row0, s);
    z = zn;
  }
}

template <int TM>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
pinv_bwd_kernel(const float* __restrict__ x_all, const float* __restrict__ c_ptr,
                const float* __restrict__ g_all, float* __restrict__ dx_all,
                float* __restrict__ dcp, float* __restrict__ part, float* __restrict__ ws_all,
                int m, int iters) {
  __shared__ __align__(16) Smem s;
  constexpr int R = TM * kWarps;
  const size_t mat = cluster_index(), mm2 = (size_t)m * m;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int row0 = rank * R;
  const float* x = x_all + mat * mm2;
  const float* gout = g_all + mat * mm2;
  float* dx = dx_all + mat * mm2;
  float* zs = ws_all + mat * (size_t)(iters + 8) * mm2;  // the iterates z_0 .. z_{iters-1}
  float* y = zs + (size_t)iters * mm2;
  float* t3 = y + mm2;
  float* mm = t3 + mm2;
  float* dm = mm + mm2;
  float* dt2 = dm + mm2;
  float* dy = dt2 + mm2;
  float* dz = dy + mm2;
  float* tmp = dz + mm2;  // dt1, then dzi
  const float c = *c_ptr;

  // forward replay, stashing each iterate
  transpose_div(x, zs, m, row0, R, c);
  for (int i = 0; i + 1 < iters; ++i) {
    cluster_sync();
    ns_step<TM>(x, zs + i * mm2, zs + (i + 1) * mm2, y, t3, mm, m, row0, s);
  }
  for (int f = threadIdx.x; f < R * m / 4; f += kThreads) {
    const size_t off = (size_t)row0 * m + 4 * f;
    *reinterpret_cast<float4*>(dz + off) = ld4(gout + off);
  }

  // reverse sweep
  for (int i = iters - 1; i >= 0; --i) {
    const float* zi = zs + i * mm2;
    cluster_sync();  // z_i and dz complete
    band_product<TM>({x, false}, plain(zi), to(y), m, row0, s);
    band_product<TM>({zi, true}, plain(dz), to(dm, 0.25f), m, row0, s);
    cluster_sync();
    band_product<TM>({y, false}, {y, false, -1.f, 7.f}, to(t3, -1.f, 15.f), m, row0, s);
    band_product<TM>({y, true}, plain(dm), to(dt2), m, row0, s);  // dt2 = -dt3 = y^T dm
    cluster_sync();
    band_product<TM>({y, false}, plain(t3), to(mm, -1.f, 13.f), m, row0, s);
    band_product<TM>({y, true}, plain(dt2), to(tmp), m, row0, s);  // dt1
    band_product<TM>({dm, false}, plain(t3, true), to(dy, -1.f), m, row0, s);  // dt4 t3^T
    // dy = (dy + dt2 t1^T) - dt1, t1^T = 7I - y^T
    band_product<TM>({dt2, false}, {y, true, -1.f, 7.f}, to(dy, 1.f, 0.f, dy, tmp, -1.f), m,
                     row0, s);
    cluster_sync();
    band_product<TM>({dz, false}, plain(mm, true), to(tmp, 0.25f), m, row0, s);  // dzi
    band_product<TM>({dy, false}, plain(zi, true),
                     to(dx, 1.f, 0.f, i == iters - 1 ? nullptr : dx), m, row0, s);
    band_product<TM>({x, true}, plain(dy), to(dz, 1.f, 0.f, tmp), m, row0, s);
  }
  cluster_sync();  // dz complete

  // z_0 = x^T / c: dx += dz^T / c, and this band's part of sum(x^T . dz)
  float acc = 0.f;
  for (int f = threadIdx.x; f < R * m; f += kThreads) {
    const int r = row0 + f / m, j = f % m;
    const size_t off = (size_t)r * m + j;
    dx[off] = dx[off] + __ldcg(dz + (size_t)j * m + r) / c;
    acc += __ldcg(x + (size_t)j * m + r) * __ldcg(dz + off);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) s.red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float band = 0.f;
    for (int w = 0; w < kWarps; ++w) band += s.red[w];
    part[mat * kCluster + rank] = band;
  }
  cluster_sync();
  if (rank == 0 && threadIdx.x == 0) {
    float total = 0.f;
    for (int r = 0; r < kCluster; ++r) total += __ldcg(part + mat * kCluster + r);
    dcp[mat] = -total / (c * c);
  }
}

bool bad_shape(int g, int m, int iters) {
  return g < 1 || iters < 1 || m < kChunkN || m > kMaxBand * kCluster || m % kChunkN;
}

}  // namespace

// x, z [g, m, m] fp32 contiguous, 16-byte aligned, m in {128, 256, 384, 512};
// c one fp32 on the card; ws [g, 4, m, m] scratch. Launches on `stream`;
// returns cudaGetLastError() (0 = launched).
extern "C" int imp_pinv_fwd_f32(const float* x, const float* c, float* z, float* ws, int g, int m,
                                int iters, void* stream) {
  if (bad_shape(g, m, iters)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(g * kCluster);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 128: pinv_fwd_kernel<2><<<grid, kThreads, 0, st>>>(x, c, z, ws, m, iters); break;
    case 256: pinv_fwd_kernel<4><<<grid, kThreads, 0, st>>>(x, c, z, ws, m, iters); break;
    case 384: pinv_fwd_kernel<6><<<grid, kThreads, 0, st>>>(x, c, z, ws, m, iters); break;
    default: pinv_fwd_kernel<8><<<grid, kThreads, 0, st>>>(x, c, z, ws, m, iters); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// As above, plus g_out [g, m, m] (the cotangent of z); writes dx [g, m, m]
// and dcp [g], one normaliser-gradient partial per matrix; part [g, 8] and
// ws [g, iters + 8, m, m] are scratch.
extern "C" int imp_pinv_bwd_f32(const float* x, const float* c, const float* g_out, float* dx,
                                float* dcp, float* part, float* ws, int g, int m, int iters,
                                void* stream) {
  if (bad_shape(g, m, iters)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(g * kCluster);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 128:
      pinv_bwd_kernel<2><<<grid, kThreads, 0, st>>>(x, c, g_out, dx, dcp, part, ws, m, iters);
      break;
    case 256:
      pinv_bwd_kernel<4><<<grid, kThreads, 0, st>>>(x, c, g_out, dx, dcp, part, ws, m, iters);
      break;
    case 384:
      pinv_bwd_kernel<6><<<grid, kThreads, 0, st>>>(x, c, g_out, dx, dcp, part, ws, m, iters);
      break;
    default:
      pinv_bwd_kernel<8><<<grid, kThreads, 0, st>>>(x, c, g_out, dx, dcp, part, ws, m, iters);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
