// Masked flash-attention backward for Hopper (sm_90a): two kernels, launched
// one after the other by the same wrapper. q, k, v in fp32 (the _f32
// entries) or bf16 (the _bf16 entries); bias, dO, lse, delta and the
// gradients fp32.
//
//  * dq_kernel replaces imp_tpu/ops/flash_attention.py:104 _make_dq_kernel (K2)
//  * dkv_kernel replaces imp_tpu/ops/flash_attention.py:144 _make_dkv_kernel (K3)
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
// What bounds it on the H100. K2 does 3 products (6*B*H*Nq*Nk*d FLOPs) and
// K3 4 (8*B*H*Nq*Nk*d), each plus B*H*Nq*Nk exps, against q, k, v, dO, lse,
// delta read once and the gradients written once: compute-bound. The TPU
// kernel feeds fp32 operands to its matrix unit; here every tile product
// runs on the tensor cores in 3xTF32 (mma.sync m16n8k8 TF32, fp32
// accumulate): each operand x is split into big = x rounded to TF32 and
// small = x - big, and a.b = big.big + big.small + small.big, which
// keeps fp32 accuracy (one TF32 pass keeps ~3 decimal digits and fails the
// 1e-4 gate). The ceiling is then a third of the 494.7 TFLOP/s TF32 peak,
// ~165 TFLOP/s: at TransMIL's bag (N = 10 001, 7 314 valid keys, d = 64, 8
// heads) ~1.36 ms (K2) and ~1.82 ms (K3), where the 67 TFLOP/s fp32 CUDA
// cores would need 3.4 and 4.5 ms.
//
// Design:
//  * A CTA of 4 warps owns 64 output rows and sweeps the reduction axis in
//    tiles of 64, so every sum is made in one thread's registers in a fixed
//    order: deterministic, no atomics. K2: a query tile, with Q and dO
//    resident, sweeping key tiles (K, V, bias). K3: a key tile, with K and V
//    resident, sweeping query tiles (Q, dO, lse, delta). Each warp owns 16
//    of the 64 rows; its accumulators (dQ, or dK and dV) stay in registers.
//  * Every operand stays fp32 in shared memory and is split into big and
//    small halves as its fragment is loaded (3 ALU operations an element).
//    Splitting the resident tiles once instead would double their shared
//    memory (139 776 bytes a CTA at d = 64) and leave one CTA of 4 warps per
//    SM; as it is, 104 960 bytes (K2) and 105 472 (K3) let two share an SM. Registers hold only the
//    accumulators and the fragments in flight (K3's dK and dV already take
//    64 a thread). Rows are padded to d + 4 floats, so every fragment load
//    below is free of bank conflicts.
//  * The long sums (dq over keys, dk and dv over queries) are not left in
//    the tensor core's accumulator, whose adds lose precision as a sum grows
//    over thousands of keys, to near the 1e-4 gate at TransMIL's bag. K2
//    sums a key tile's part of dQ there and adds it to dQ with an fp32 add;
//    K3 adds each 3xTF32 product that way (a second set of dK and dV parts
//    would not fit in registers).
//  * S (or S^T) and dP leave the MMA in the accumulator layout, where P and
//    dS are formed in fp32. They feed the next product as the A operand
//    without any data movement: the 8 keys of a k-step are taken in the
//    order 0,2,4,6,1,3,5,7, which is what the accumulator layout holds per
//    thread, and the B operand's rows are read in the same order.
//  * Swept tiles are double-buffered with cp.async (16 B, .cg; 4 B for the
//    bias, lse and delta rows), so tile t+1 loads while tile t computes.
//  * Fully masked key tiles are skipped, exactly, in a slide that has at
//    least one valid key (found by scanning its bias row): there every
//    query row's lse is far above -1e30, so a masked key gets P = 0 and
//    dS = 0 exactly and adds nothing. K2 skips such a key tile without
//    loading it (a block vote over its 64 biases); K3 writes zeros for such
//    a tile and returns. A slide with no valid key sweeps every key (P = 1).
//    The mask is any bias row: the vote is per tile, never from a length.
//
//  * The bf16 entries (TRAINER.PREC bf16; the TPU kernels' contract under
//    mxu_precision="fp32": q, k, v read as bf16, dO cast to fp32 by the
//    caller, fp32 gradients) widen q, k and v exactly to fp32 as they stage
//    them, so they give the fp32 entries' bits on widened copies; only the
//    operand bytes of q, k, v halve.
//
// The products, fragment loaders, copies and the masked-tile vote live in
// tf32x3.cuh, shared with K1 (flash_fwd.cu).
//
// Left for later: warp specialisation (a producer warp for the copies),
// wgmma with TMA, and persistent CTAs over (b, h, tile).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

// ---------------------------------------------------------------------------
// K2: dq
// ---------------------------------------------------------------------------

// one key tile: S = Q K^T and dP = dO V^T (this warp's 16 rows x 64 keys),
// P and dS, then dQ += dS K
template <int D>
__device__ __forceinline__ void dq_tile(const float* qt, const float* ot, const float* kt,
                                        const float* vt, const float* bt, const float* lse_r,
                                        const float* delta_r, float (*dqa)[4]) {
  constexpr int S = D + kPad, NT = kTile / 8, KS = D / 8;
  const int t = threadIdx.x & 3, r0 = (threadIdx.x >> 5) * 16;
  float sa[NT][4], pa[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[j][e] = pa[j][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t qab[4], qas[4], oab[4], oas[4];
    load_a<S>(qt, r0, ks * 8, qab, qas);
    load_a<S>(ot, r0, ks * 8, oab, oas);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bb[2], bs[2];
      load_b_rows_n<S>(kt, j * 8, ks * 8, bb, bs);
      mma3(sa[j], qab, qas, bb, bs);
      load_b_rows_n<S>(vt, j * 8, ks * 8, bb, bs);
      mma3(pa[j], oab, oas, bb, bs);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 bias2 = *reinterpret_cast<const float2*>(bt + j * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(sa[j][e] + ((e & 1) ? bias2.y : bias2.x) - lse_r[e >> 1]);
      sa[j][e] = p * (pa[j][e] - delta_r[e >> 1]);  // dS
    }
  }
  float part[KS][4];  // this key tile's part of dQ, added to dQ in fp32
#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t ab[4], as[4];
    a_from_c(sa[j], ab, as);
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      uint32_t bb[2], bs[2];
      load_b_rows_k<S>(kt, j * 8, n * 8, bb, bs);
      mma3(part[n], ab, as, bb, bs);
    }
  }
#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] += part[n][e];
  }
}

// One CTA per (b, h, tile of kTile queries); sweeps the live key tiles.
// T is the element type of q, k and v (float or __nv_bfloat16).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const float* __restrict__ bias,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, int H, int Nq, int Nk) {
  constexpr int S = D + kPad, TILE = kTile * S, KS = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // resident Q
  float* ot = qt + TILE;        // resident dO
  float* kst = ot + TILE;       // [2][TILE] swept K
  float* vst = kst + 2 * TILE;  // [2][TILE] swept V
  float* bst = vst + 2 * TILE;  // [2][kTile] swept bias

  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const T* kb = k + bh * Nk * D;
  const T* vb = v + bh * Nk * D;
  const float* biasb = bias + (size_t)b * Nk;
  const int nt = (Nk + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;

  stage_rows<D>(qt, q + bh * Nq * D, q0, Nq);  // lands with the first key tile
  stage_rows<D>(ot, dout + bh * Nq * D, q0, Nq);
  // a query past Nq gets lse = +inf: P = 0 on every key, so it adds nothing
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    lse_r[i] = row < Nq ? lse[bh * Nq + row] : INFINITY;
    delta_r[i] = row < Nq ? delta[bh * Nq + row] : 0.f;
  }
  float dqa[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
  }

  const bool any_key = slide_has_key(biasb, Nk);
  float bval = -INFINITY;
  // keys past Nk are zero with bias -inf: P = 0 and dS = 0, never a NaN
  int tile = next_live_tile(biasb, Nk, nt, 0, any_key, bval);
  int buf = 0;
  if (tile < nt) {
    stage_rows<D>(kst, kb, tile * kTile, Nk);
    stage_rows<D>(vst, vb, tile * kTile, Nk);
    if (threadIdx.x < kTile) bst[threadIdx.x] = bval;
  }
  cp_async_commit();
  while (tile < nt) {
    const int next = next_live_tile(biasb, Nk, nt, tile + 1, any_key, bval);
    if (next < nt) {  // the other buffer was released by the last barrier
      stage_rows<D>(kst + (buf ^ 1) * TILE, kb, next * kTile, Nk);
      stage_rows<D>(vst + (buf ^ 1) * TILE, vb, next * kTile, Nk);
      if (threadIdx.x < kTile) bst[(buf ^ 1) * kTile + threadIdx.x] = bval;
    }
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    dq_tile<D>(qt, ot, kst + buf * TILE, vst + buf * TILE, bst + buf * kTile, lse_r,
               delta_r, dqa);
    __syncthreads();  // the next stage overwrites this buffer
    buf ^= 1;
    tile = next;
  }

  float* dqb = dq + bh * Nq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    if (row < Nq) {
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        *reinterpret_cast<float2*>(dqb + (size_t)row * D + n * 8 + 2 * t4) =
            make_float2(dqa[n][2 * i], dqa[n][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dk and dv
// ---------------------------------------------------------------------------

// one query tile, 16 queries at a time (to bound the live registers):
// S^T = K Q^T and dP^T = V dO^T (this warp's 16 keys x 16 queries), P^T and
// dS^T, then dV += P^T dO and dK += dS^T Q
template <int D>
__device__ __forceinline__ void dkv_tile(const float* kt, const float* vt, const float* qt,
                                         const float* ot,
                                         const float* lt, const float* dlt, const float* bias_r,
                                         float (*dka)[4], float (*dva)[4]) {
  constexpr int S = D + kPad, NH = 2, KS = D / 8;
  const int t = threadIdx.x & 3, r0 = (threadIdx.x >> 5) * 16;
#pragma unroll 1
  for (int part = 0; part < kTile / (8 * NH); ++part) {
    float sa[NH][4], pa[NH][4];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[j][e] = pa[j][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kab[4], kas[4], vab[4], vas[4];
      load_a<S>(kt, r0, kk * 8, kab, kas);
      load_a<S>(vt, r0, kk * 8, vab, vas);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const int c0 = (part * NH + j) * 8;
        uint32_t bb[2], bs[2];
        load_b_rows_n<S>(qt, c0, kk * 8, bb, bs);
        mma3(sa[j], kab, kas, bb, bs);
        load_b_rows_n<S>(ot, c0, kk * 8, bb, bs);
        mma3(pa[j], vab, vas, bb, bs);
      }
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int col = (part * NH + j) * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dlt + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sa[j][e] + bias_r[e >> 1] - ((e & 1) ? l2.y : l2.x));
        sa[j][e] = p;                                            // P^T
        pa[j][e] = p * (pa[j][e] - ((e & 1) ? d2.y : d2.x));     // dS^T
      }
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int c0 = (part * NH + j) * 8;
      uint32_t pb[4], ps[4], db[4], ds[4];
      a_from_c(sa[j], pb, ps);
      a_from_c(pa[j], db, ds);
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        uint32_t bb[2], bs[2];
        load_b_rows_k<S>(ot, c0, n * 8, bb, bs);
        mma3_add(dva[n], pb, ps, bb, bs);
        load_b_rows_k<S>(qt, c0, n * 8, bb, bs);
        mma3_add(dka[n], db, ds, bb, bs);
      }
    }
  }
}

// One CTA per (b, h, tile of kTile keys); sweeps every query tile.
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const float* __restrict__ bias,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dk,
           float* __restrict__ dv, int H, int Nq, int Nk) {
  constexpr int S = D + kPad, TILE = kTile * S, KS = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;             // resident K
  float* vt = kt + TILE;        // resident V
  float* qst = vt + TILE;       // [2][TILE] swept Q
  float* ost = qst + 2 * TILE;  // [2][TILE] swept dO
  float* lst = ost + 2 * TILE;  // [2][kTile] swept lse
  float* dlst = lst + 2 * kTile;  // [2][kTile] swept delta

  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const float* biasb = bias + (size_t)b * Nk;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  float* dkb = dk + bh * Nk * D;
  float* dvb = dv + bh * Nk * D;

  // a fully masked key tile in a slide with a valid key: dk = dv = 0 exactly
  const int own = k0 + threadIdx.x;
  const bool live = __syncthreads_or(threadIdx.x < kTile && own < Nk && biasb[own] > kMaskedBelow);
  if (!live && slide_has_key(biasb, Nk)) {
    constexpr int C = D / 4;
    for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
      const int r = k0 + i / C;
      if (r < Nk) {
        const size_t o = (size_t)r * D + 4 * (i % C);
        *reinterpret_cast<float4*>(dkb + o) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dvb + o) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  const T* qb = q + bh * Nq * D;
  const float* ob = dout + bh * Nq * D;
  const float* lb = lse + bh * Nq;
  const float* db = delta + bh * Nq;
  const int nt = (Nq + kTile - 1) / kTile;
  // queries past Nq are zero with lse = delta = 0: their P multiplies a zero
  // dO row and their dS = P (0 - 0) = 0, so they add exactly nothing
  stage_rows<D>(kt, k + bh * Nk * D, k0, Nk);  // lands with the first query tile
  stage_rows<D>(vt, v + bh * Nk * D, k0, Nk);
  stage_rows<D>(qst, qb, 0, Nq);
  stage_rows<D>(ost, ob, 0, Nq);
  stage_vec(lst, lb, 0, Nq);
  stage_vec(dlst, db, 0, Nq);
  cp_async_commit();
  // a key past Nk gets bias -inf: P = 0 for every query
  float bias_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r0 + g + 8 * i;
    bias_r[i] = key < Nk ? biasb[key] : -INFINITY;
  }
  float dka[KS][4], dva[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  }

  for (int tile = 0, buf = 0; tile < nt; ++tile, buf ^= 1) {
    if (tile + 1 < nt) {  // the other buffer was released by the last barrier
      const int n0 = (tile + 1) * kTile;
      stage_rows<D>(qst + (buf ^ 1) * TILE, qb, n0, Nq);
      stage_rows<D>(ost + (buf ^ 1) * TILE, ob, n0, Nq);
      stage_vec(lst + (buf ^ 1) * kTile, lb, n0, Nq);
      stage_vec(dlst + (buf ^ 1) * kTile, db, n0, Nq);
    }
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    dkv_tile<D>(kt, vt, qst + buf * TILE, ost + buf * TILE, lst + buf * kTile,
                dlst + buf * kTile, bias_r, dka, dva);
    __syncthreads();  // the next stage overwrites this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + r0 + g + 8 * i;
    if (row < Nk) {
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        const size_t o = (size_t)row * D + n * 8 + 2 * t4;
        *reinterpret_cast<float2*>(dkb + o) = make_float2(dka[n][2 * i], dka[n][2 * i + 1]);
        *reinterpret_cast<float2*>(dvb + o) = make_float2(dva[n][2 * i], dva[n][2 * i + 1]);
      }
    }
  }
}

// dynamic shared memory: two resident tiles, two double-buffered swept
// tiles and the swept vectors (K2: bias; K3: lse and delta): 104 960 and
// 105 472 bytes at d = 64, so two CTAs share an SM
template <int D>
constexpr size_t dq_smem_bytes() {
  return (6 * kTile * (D + kPad) + 2 * kTile) * sizeof(float);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return (6 * kTile * (D + kPad) + 4 * kTile) * sizeof(float);
}

template <int D, typename T>
int launch_dq(const T* q, const T* k, const T* v, const float* bias, const float* dout,
              const float* lse, const float* delta, float* dq, int B, int H, int Nq, int Nk,
              cudaStream_t s) {
  const int set = allow_smem(dq_kernel<D, T>, dq_smem_bytes<D>());
  if (set) return set;
  const dim3 grid((Nq + kTile - 1) / kTile, H, B);
  dq_kernel<D, T><<<grid, kThreads, dq_smem_bytes<D>(), s>>>(q, k, v, bias, dout, lse, delta,
                                                              dq, H, Nq, Nk);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch_dkv(const T* q, const T* k, const T* v, const float* bias, const float* dout,
               const float* lse, const float* delta, float* dk, float* dv, int B, int H, int Nq,
               int Nk, cudaStream_t s) {
  const int set = allow_smem(dkv_kernel<D, T>, dkv_smem_bytes<D>());
  if (set) return set;
  const dim3 grid((Nk + kTile - 1) / kTile, H, B);
  dkv_kernel<D, T><<<grid, kThreads, dkv_smem_bytes<D>(), s>>>(q, k, v, bias, dout, lse, delta,
                                                                dk, dv, H, Nq, Nk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dq_entry(const T* q, const T* k, const T* v, const float* bias, const float* dout,
             const float* lse, const float* delta, float* dq, int B, int H, int Nq, int Nk,
             int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch_dq<32>(q, k, v, bias, dout, lse, delta, dq, B, H, Nq, Nk, s);
  if (D == 64) return launch_dq<64>(q, k, v, bias, dout, lse, delta, dq, B, H, Nq, Nk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dkv_entry(const T* q, const T* k, const T* v, const float* bias, const float* dout,
              const float* lse, const float* delta, float* dk, float* dv, int B, int H, int Nq,
              int Nk, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch_dkv<32>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Nq, Nk, s);
  if (D == 64) return launch_dkv<64>(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Nq, Nk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, dO [B,H,Nq,D], k/v [B,H,Nk,D], bias [B,Nk], lse/delta [B,H,Nq],
// dq [B,H,Nq,D]: contiguous fp32, 16-byte aligned, Nq >= 1, Nk >= 1,
// D in {32, 64}. Launches on `stream` and returns the cudaError_t of the
// shared-memory attribute or of the launch.
extern "C" int imp_flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                                    const float* bias, const float* dout, const float* lse,
                                    const float* delta, float* dq, int B, int H, int Nq,
                                    int Nk, int D, void* stream) {
  return dq_entry(q, k, v, bias, dout, lse, delta, dq, B, H, Nq, Nk, D, stream);
}

// the same inputs; dk, dv [B,H,Nk,D]
extern "C" int imp_flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                     const float* bias, const float* dout, const float* lse,
                                     const float* delta, float* dk, float* dv, int B, int H,
                                     int Nq, int Nk, int D, void* stream) {
  return dkv_entry(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Nq, Nk, D, stream);
}

// The same two with q, k, v in bf16 (contiguous, 16-byte aligned); dO, lse,
// delta and the gradients stay fp32. They give the _f32 entries' bits on
// fp32 copies of q, k, v.
extern "C" int imp_flash_bwd_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                     const __nv_bfloat16* v, const float* bias,
                                     const float* dout, const float* lse, const float* delta,
                                     float* dq, int B, int H, int Nq, int Nk, int D,
                                     void* stream) {
  return dq_entry(q, k, v, bias, dout, lse, delta, dq, B, H, Nq, Nk, D, stream);
}

extern "C" int imp_flash_bwd_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                      const __nv_bfloat16* v, const float* bias,
                                      const float* dout, const float* lse, const float* delta,
                                      float* dk, float* dv, int B, int H, int Nq, int Nk, int D,
                                      void* stream) {
  return dkv_entry(q, k, v, bias, dout, lse, delta, dk, dv, B, H, Nq, Nk, D, stream);
}

// The launch layout, for reports and tests: the rows a CTA owns and sweeps
// per tile (K2 skips and K3 zero-fills masked keys a tile at a time) and
// each kernel's dynamic shared memory in bytes at head width D.
extern "C" int imp_flash_bwd_layout(int D, int* tile, int* dq_smem, int* dkv_smem) {
  *tile = kTile;
  if (D == 32) {
    *dq_smem = static_cast<int>(dq_smem_bytes<32>());
    *dkv_smem = static_cast<int>(dkv_smem_bytes<32>());
  } else if (D == 64) {
    *dq_smem = static_cast<int>(dq_smem_bytes<64>());
    *dkv_smem = static_cast<int>(dkv_smem_bytes<64>());
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}
