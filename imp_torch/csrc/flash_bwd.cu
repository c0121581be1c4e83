// Masked flash-attention backward for Hopper (sm_90a), fp32 in and out:
// two kernels, launched one after the other by the same wrapper.
//
//  * dq_kernel replaces imp_tpu/ops/flash_attention.py::_make_dq_kernel (K2)
//  * dkv_kernel replaces imp_tpu/ops/flash_attention.py::_make_dkv_kernel (K3)
//
// Contract (the TPU kernels' and the plain version's): for pre-scaled q, an
// additive key-bias row (0 valid / -1e30 masked), the output cotangent dO,
// and the row statistics lse = logsumexp_j(s_ij) and delta = rowsum(dO * O)
// SUPPLIED BY THE CALLER,
//   s_ij = q_i . k_j + bias_j,  P_ij = exp(s_ij - lse_i)  (not a softmax),
//   dP_ij = dO_i . v_j,         dS_ij = P_ij (dP_ij - delta_i),
//   dq_i = sum_j dS_ij k_j,  dk_j = sum_i dS_ij q_i,  dv_j = sum_i P_ij dO_i.
// A query row whose keys are all masked has lse ~ -1e30, so P = 1 on every
// key, as on the TPU. Keys and queries past Nk / Nq (the ragged edge of the
// last tile) are excluded here, so the caller pads nothing.
//
// What bounds it on the H100: K2 does 3 products (6*B*H*Nq*Nk*d FLOPs) plus
// B*H*Nq*Nk exps, K3 4 products (8*B*H*Nq*Nk*d FLOPs) plus the same exps,
// against q, k, v, dO, lse, delta read once and the gradients written once.
// The fp32 contract rules out the tensor cores (TF32 keeps ~3 decimal
// digits), so the ceiling is the 67 TFLOP/s of the fp32 CUDA cores; at the
// TransMIL bag (N = 10 001, d = 64, 8 heads) that is ~4.6 ms (K2) and
// ~6.1 ms (K3) against ~20 us of memory traffic: compute-bound.
//
// Design (simple first; wgmma/TMA/pipelining are later work):
//  * The TPU grids walk the reduction axis in order and carry the sums in
//    VMEM scratch. Here each block owns a tile of the OUTPUT rows and loops
//    over the whole reduction axis itself, so every sum is made in one
//    thread's registers in a fixed order: deterministic, no atomics.
//    K2: a block owns a query tile and loops over every key tile, recomputing
//    S and P. K3: a block owns a key tile and loops over every query tile,
//    staging that tile's q, dO, lse and delta in shared memory.
//  * A row of d = 64 per thread would hold q, dO and dq (192 floats, K2) or
//    k, v, dk and dv (256 floats, K3): past the 255-register limit. So a row
//    is split over TPR = d / 32 threads, each holding 32 of its dims; the
//    two halves' dot products meet in one __shfl_xor_sync. The halves sit
//    16 lanes apart, so each quarter-warp reads ONE shared address of the
//    staged tile (a broadcast, no bank conflict).
//  * The staged tile is consumed in chunks of kChunk rows: first their dot
//    products (and the shuffles, which then overlap), then their rank-one
//    updates, so only 2*kChunk scalars are live beside the row state.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // rows of the reduction axis staged per step
constexpr int kChunk = 8;  // rows consumed per chunk of the staged tile

template <int D>
struct Layout {
  static constexpr int TPR = D / 32;          // threads per output row
  static constexpr int DT4 = 8;               // float4s of a row per thread
  static constexpr int D4 = D / 4;            // float4s of a row
  static constexpr int LANES = 32 / TPR;      // rows per warp
  static constexpr int ROWS = kThreads / TPR; // rows per block
  static_assert(D == 32 || D == 64, "head dim must be 32 or 64");
};

// this thread's output row within the block and which 32-dim part it holds
template <int D>
__device__ __forceinline__ void thread_row(int& row, int& part) {
  using L = Layout<D>;
  const int lane = threadIdx.x & 31;
  part = lane / L::LANES;
  row = blockIdx.x * L::ROWS + (threadIdx.x >> 5) * L::LANES + lane % L::LANES;
}

// the full dot product of a row split over TPR lanes 16 apart
template <int D>
__device__ __forceinline__ float row_sum(float x) {
  if (Layout<D>::TPR == 2) x += __shfl_xor_sync(0xffffffffu, x, 16);
  return x;
}

__device__ __forceinline__ float dot4(const float* r, float4 t, float acc) {
  acc = fmaf(r[0], t.x, acc);
  acc = fmaf(r[1], t.y, acc);
  acc = fmaf(r[2], t.z, acc);
  return fmaf(r[3], t.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 t, float* r) {
  r[0] = fmaf(a, t.x, r[0]);
  r[1] = fmaf(a, t.y, r[1]);
  r[2] = fmaf(a, t.z, r[2]);
  r[3] = fmaf(a, t.w, r[3]);
}

// this thread's 32 dims of row `row` of a [rows, D] matrix, zero past `n`
template <int D>
__device__ __forceinline__ void load_part(const float* base, int row, int n, int part,
                                          float* r) {
  using L = Layout<D>;
  if (row < n) {
    const float4* p = reinterpret_cast<const float4*>(base + (size_t)row * D) + part * L::DT4;
#pragma unroll
    for (int c = 0; c < L::DT4; ++c) {
      const float4 t = p[c];
      r[4 * c] = t.x; r[4 * c + 1] = t.y; r[4 * c + 2] = t.z; r[4 * c + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < 32; ++c) r[c] = 0.f;
  }
}

template <int D>
__device__ __forceinline__ void store_part(float* base, int row, int part, const float* r) {
  using L = Layout<D>;
  float4* p = reinterpret_cast<float4*>(base + (size_t)row * D) + part * L::DT4;
#pragma unroll
  for (int c = 0; c < L::DT4; ++c) {
    p[c] = make_float4(r[4 * c], r[4 * c + 1], r[4 * c + 2], r[4 * c + 3]);
  }
}

// stage rows [r0, r0 + kTile) of two [n, D] matrices into shared memory,
// zero past n
template <int D>
__device__ __forceinline__ void stage_pair(const float4* a, const float4* b, int r0, int n,
                                           float4* as, float4* bs) {
  using L = Layout<D>;
  const int nvalid = min(kTile, n - r0);
  for (int i = threadIdx.x; i < kTile * L::D4; i += kThreads) {
    const bool in = i < nvalid * L::D4;
    as[i] = in ? a[(size_t)r0 * L::D4 + i] : make_float4(0.f, 0.f, 0.f, 0.f);
    bs[i] = in ? b[(size_t)r0 * L::D4 + i] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// K2: dq. One block per (b, h, tile of ROWS queries); loops over key tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ bias,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq,
          int H, int Nq, int Nk) {
  using L = Layout<D>;
  __shared__ __align__(16) float4 ks[kTile * L::D4];
  __shared__ __align__(16) float4 vs[kTile * L::D4];
  __shared__ float bs[kTile];

  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  int row, part;
  thread_row<D>(row, part);
  const bool active = row < Nq;
  const float4* kb = reinterpret_cast<const float4*>(k + bh * Nk * D);
  const float4* vb = reinterpret_cast<const float4*>(v + bh * Nk * D);
  const float* biasb = bias + (size_t)b * Nk;

  float qr[32], dor[32], acc[32];
  load_part<D>(q + bh * Nq * D, row, Nq, part, qr);
  load_part<D>(dout + bh * Nq * D, row, Nq, part, dor);
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.f;
  // a query past Nq gets lse = +inf: P = 0 on every key, so it adds nothing
  const float lse_r = active ? lse[bh * Nq + row] : INFINITY;
  const float delta_r = active ? delta[bh * Nq + row] : 0.f;

  for (int k0 = 0; k0 < Nk; k0 += kTile) {
    // keys past Nk are zero with bias -inf: P = 0 and dS = 0, never a NaN
    stage_pair<D>(kb, vb, k0, Nk, ks, vs);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      bs[i] = k0 + i < Nk ? biasb[k0 + i] : -INFINITY;
    }
    __syncthreads();
#pragma unroll
    for (int j0 = 0; j0 < kTile; j0 += kChunk) {
      float ds[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float4* kr = ks + (j0 + j) * L::D4 + part * L::DT4;
        const float4* vr = vs + (j0 + j) * L::D4 + part * L::DT4;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < L::DT4; ++c) {
          s = dot4(qr + 4 * c, kr[c], s);
          dp = dot4(dor + 4 * c, vr[c], dp);
        }
        s = row_sum<D>(s);
        dp = row_sum<D>(dp);
        const float p = expf(s + bs[j0 + j] - lse_r);
        ds[j] = p * (dp - delta_r);
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float4* kr = ks + (j0 + j) * L::D4 + part * L::DT4;
#pragma unroll
        for (int c = 0; c < L::DT4; ++c) axpy4(ds[j], kr[c], acc + 4 * c);
      }
    }
    __syncthreads();  // the next tile overwrites ks/vs/bs
  }
  if (active) store_part<D>(dq + bh * Nq * D, row, part, acc);
}

// K3: dk and dv. One block per (b, h, tile of ROWS keys); loops over query
// tiles, staging q, dO, lse and delta.
template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ bias,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dk,
           float* __restrict__ dv, int H, int Nq, int Nk) {
  using L = Layout<D>;
  __shared__ __align__(16) float4 qs[kTile * L::D4];
  __shared__ __align__(16) float4 dos[kTile * L::D4];
  __shared__ float ls[kTile];
  __shared__ float dls[kTile];

  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  int row, part;
  thread_row<D>(row, part);
  const bool active = row < Nk;
  const float4* qb = reinterpret_cast<const float4*>(q + bh * Nq * D);
  const float4* dob = reinterpret_cast<const float4*>(dout + bh * Nq * D);

  float kr[32], vr[32], dka[32], dva[32];
  load_part<D>(k + bh * Nk * D, row, Nk, part, kr);
  load_part<D>(v + bh * Nk * D, row, Nk, part, vr);
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    dka[c] = 0.f;
    dva[c] = 0.f;
  }
  // a key past Nk gets bias -inf: P = 0 for every query
  const float bias_r = active ? bias[(size_t)b * Nk + row] : -INFINITY;

  for (int q0 = 0; q0 < Nq; q0 += kTile) {
    // queries past Nq are zero with lse +inf and delta 0: P = 0, dS = 0
    stage_pair<D>(qb, dob, q0, Nq, qs, dos);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool in = q0 + i < Nq;
      ls[i] = in ? lse[bh * Nq + q0 + i] : INFINITY;
      dls[i] = in ? delta[bh * Nq + q0 + i] : 0.f;
    }
    __syncthreads();
    // one chunk at a time: unrolling across chunks let the compiler hoist
    // the next chunk's shared loads and spill the row state (k, v, dk, dv)
#pragma unroll 1
    for (int i0 = 0; i0 < kTile; i0 += kChunk) {
      float p[kChunk], ds[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float4* qr = qs + (i0 + i) * L::D4 + part * L::DT4;
        const float4* dr = dos + (i0 + i) * L::D4 + part * L::DT4;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int c = 0; c < L::DT4; ++c) {
          s = dot4(kr + 4 * c, qr[c], s);
          dp = dot4(vr + 4 * c, dr[c], dp);
        }
        s = row_sum<D>(s);
        dp = row_sum<D>(dp);
        p[i] = expf(s + bias_r - ls[i0 + i]);
        ds[i] = p[i] * (dp - dls[i0 + i]);
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float4* qr = qs + (i0 + i) * L::D4 + part * L::DT4;
        const float4* dr = dos + (i0 + i) * L::D4 + part * L::DT4;
#pragma unroll
        for (int c = 0; c < L::DT4; ++c) {
          axpy4(p[i], dr[c], dva + 4 * c);
          axpy4(ds[i], qr[c], dka + 4 * c);
        }
      }
    }
    __syncthreads();  // the next tile overwrites qs/dos/ls/dls
  }
  if (active) {
    store_part<D>(dk + bh * Nk * D, row, part, dka);
    store_part<D>(dv + bh * Nk * D, row, part, dva);
  }
}

template <int D>
dim3 grid_of(int rows, int H, int B) {
  return dim3((rows + Layout<D>::ROWS - 1) / Layout<D>::ROWS, H, B);
}

}  // namespace

// q, dO [B,H,Nq,D], k/v [B,H,Nk,D], bias [B,Nk], lse/delta [B,H,Nq],
// dq [B,H,Nq,D]: contiguous fp32, 16-byte aligned, Nq >= 1, Nk >= 1,
// D in {32, 64}. Launches on `stream` and returns cudaGetLastError().
extern "C" int imp_flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                                    const float* bias, const float* dout, const float* lse,
                                    const float* delta, float* dq, int B, int H, int Nq,
                                    int Nk, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) {
    dq_kernel<32><<<grid_of<32>(Nq, H, B), kThreads, 0, s>>>(q, k, v, bias, dout, lse, delta,
                                                           dq, H, Nq, Nk);
  } else if (D == 64) {
    dq_kernel<64><<<grid_of<64>(Nq, H, B), kThreads, 0, s>>>(q, k, v, bias, dout, lse, delta,
                                                           dq, H, Nq, Nk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// the same inputs; dk, dv [B,H,Nk,D]
extern "C" int imp_flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                     const float* bias, const float* dout, const float* lse,
                                     const float* delta, float* dk, float* dv, int B, int H,
                                     int Nq, int Nk, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) {
    dkv_kernel<32><<<grid_of<32>(Nk, H, B), kThreads, 0, s>>>(q, k, v, bias, dout, lse, delta,
                                                            dk, dv, H, Nq, Nk);
  } else if (D == 64) {
    dkv_kernel<64><<<grid_of<64>(Nk, H, B), kThreads, 0, s>>>(q, k, v, bias, dout, lse, delta,
                                                            dk, dv, H, Nq, Nk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
