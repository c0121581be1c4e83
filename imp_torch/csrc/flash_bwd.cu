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
//    caller, fp32 gradients) are kernels of their own, dq_kernel_bf16 and
//    dkv_kernel_bf16. What bounds them: each product at the rate its
//    operands need (chip_smoke.flash_bound_ms). Q K^T of two bf16 operands
//    is exact as one bf16 pass (989 TFLOP/s); dO V^T, dS K and dS^T Q have
//    one bf16 operand, exact in TF32, so two TF32 passes keep fp32 accuracy
//    (494.7/2 TFLOP/s); P^T dO stays 3xTF32. At TransMIL's bag that is
//    0.68 ms (K2) and 1.14 ms (K3). Widening q, k, v to the fp32 design
//    ran 3.7 and 4.7 ms past that, mostly passes that added exact zeros.
//    The design follows the operands:
//     - Q, K and V stay bf16 in shared memory, copied by cp.async in
//       16-byte chunks into rows padded to d + 8 values (ldmatrix free of
//       bank conflicts): 65 024 bytes (K2) and 72 704 (K3) at d = 64
//       against 104 960 and 105 472, so K2 runs three CTAs an SM and K3
//       three at d = 32 (at d = 64 its registers hold it to two).
//     - Q K^T (K Q^T in K3) is one mma.sync.m16n8k16 bf16 pass, fp32
//       accumulate, on ldmatrix fragments: every product is exact.
//     - A bf16 operand of a TF32 product is widened exactly (a 16-bit shift
//       or mask) from its ldmatrix fragment (.trans where its rows are the
//       k axis), so no fp32 copy of q, k or v exists; the fp32 operand
//       (dO, dS) is split as before and only its big and small halves pass
//       (the passes against the bf16 operand's small half would add zeros).
//     - K2 reads dO in pairs (rows padded to d + 8 floats) with its 8 dims
//       of a k-step in the order 0,2,4,6,1,3,5,7, which V's ldmatrix
//       fragments hold; K3 keeps V's A fragments packed in registers for
//       the whole sweep and reads dO as the fp32 entry does (P^T dO is
//       that entry's product).
//    The rest is the fp32 entries' design: the CTA of 4 warps over 64 rows,
//    fixed-order sums without atomics (the same bits on every launch), the
//    long sums out of the accumulator, the masked-tile vote and skip, the
//    ragged edges, P = 1 on a slide without a valid key. They sum Q K^T in
//    another order than the fp32 entries, so they do not give those bits on
//    widened copies (K1's bf16 entry does).
//
// The products, fragment loaders, copies and the masked-tile vote live in
// tf32x3.cuh, shared with K1 (flash_fwd.cu); the bf16 entries' primitives in
// bf16mma.cuh.
//
// Left for later: warp specialisation (a producer warp for the copies),
// wgmma with TMA, and persistent CTAs over (b, h, tile).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16mma.cuh"

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
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ bias,
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
  const float* kb = k + bh * Nk * D;
  const float* vb = v + bh * Nk * D;
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
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ bias,
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

  const float* qb = q + bh * Nq * D;
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

// ---------------------------------------------------------------------------
// K2 and K3's bf16 entries: q, k, v in bf16
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// dynamic shared memory, swept tiles double-buffered as in the fp32
// kernels: K2 resident dO (fp32) and Q (bf16), K, V (bf16) and bias per
// buffer; K3 resident K and V (bf16), Q (bf16), dO, lse and delta (fp32)
// per buffer. At d = 64 65 024 and 72 704 bytes.
template <int D>
constexpr size_t dq_bf16_smem_bytes() {
  return (kTile * (D + 8) + 2 * kTile) * sizeof(float) + 5 * kTile * (D + kPadH) * sizeof(bf16);
}

template <int D>
constexpr size_t dkv_bf16_smem_bytes() {
  return 2 * (kTile * (D + kPad) + 2 * kTile) * sizeof(float) +
         4 * kTile * (D + kPadH) * sizeof(bf16);
}

// The CTAs each SM is asked to hold (__launch_bounds__), chosen on the card
// (PERF.md): three for K2, whose registers fit the 168 a thread that asks
// for; three for K3 at d = 32 and two at d = 64, where 168 registers spill.
constexpr int kBf16DqCtas = 3;
template <int D>
constexpr int kBf16DkvCtas = D == 64 ? 2 : 3;
constexpr size_t kSmemPerSm = 228 * 1024;  // an SM's shared memory, 1 KB a CTA reserved

template <int D>
constexpr bool bf16_ctas_fit() {
  return kBf16DqCtas * (dq_bf16_smem_bytes<D>() + 1024) <= kSmemPerSm &&
         kBf16DkvCtas<D> * (dkv_bf16_smem_bytes<D>() + 1024) <= kSmemPerSm;
}
static_assert(bf16_ctas_fit<32>() && bf16_ctas_fit<64>(), "the bf16 kernels' CTAs fit an SM");

// dq_tile on bf16 Q, K, V: S = Q K^T in one bf16 pass, dP = dO V^T and
// dQ += dS K in two TF32 passes (dO's and dS's big and small halves). dO
// rows are padded to D + 8 floats (8-byte fragment loads, see load_a_pairs).
template <int D>
__device__ __forceinline__ void dq_tile_bf16(const bf16* qt, const float* ot, const bf16* kt,
                                             const bf16* vt, const float* bt, const float* lse_r,
                                             const float* delta_r, float (*dqa)[4]) {
  constexpr int SH = D + kPadH, SO = D + 8, NT = kTile / 8, KS = D / 8;
  const int t = threadIdx.x & 3, r0 = (threadIdx.x >> 5) * 16;
  float sa[NT][4], pa[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[j][e] = pa[j][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    ldm_a<SH>(qt, r0, ks * 16, a);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldm_b_rows_n<SH>(kt, j * 8, ks * 16, b);
      mma_bf16(sa[j], a, b);
      mma_bf16(sa[j + 1], a, b + 2);
    }
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ab[4], as[4];
    load_a_pairs<SO>(ot, r0, ks * 8, ab, as);
#pragma unroll
    for (int j = 0; j < NT; j += 4) {
      uint32_t b[8];
      ldm_b_rows_n_x4<SH>(vt, j * 8, ks * 8, b);
#pragma unroll
      for (int m = 0; m < 4; ++m) mma2_split_a(pa[j + m], ab, as, b + 2 * m);
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
    for (int n = 0; n < KS; n += 4) {
      uint32_t b[8];
      ldm_b_rows_k_x4<SH>(kt, j * 8, n * 8, b);
#pragma unroll
      for (int m = 0; m < 4; ++m) mma2_split_a(part[n + m], ab, as, b + 2 * m);
    }
  }
#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] += part[n][e];
  }
}

// dq_kernel on bf16 q, k, v: Q and the swept K, V tiles stay bf16 in shared
// memory, copied by cp.async, the swept ones double-buffered.
template <int D>
__global__ void __launch_bounds__(kThreads, kBf16DqCtas)
dq_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ bias,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dq, int H, int Nq, int Nk) {
  constexpr int SO = D + 8, HT = kTile * (D + kPadH), KS = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* ot = smem;                    // resident dO
  float* bst = ot + kTile * SO;        // [2][kTile] swept bias
  bf16* qt = reinterpret_cast<bf16*>(bst + 2 * kTile);  // resident Q
  bf16* kst = qt + HT;                 // [2][HT] swept K
  bf16* vst = kst + 2 * HT;            // [2][HT] swept V

  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const bf16* kb = k + bh * Nk * D;
  const bf16* vb = v + bh * Nk * D;
  const float* biasb = bias + (size_t)b * Nk;
  const int nt = (Nk + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;

  stage_rows_bf16<D>(qt, q + bh * Nq * D, q0, Nq);  // lands with the first key tile
  stage_rows_strided<D, SO>(ot, dout + bh * Nq * D, q0, Nq);
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
  auto stage = [&](int live, int into) {  // bval is live's bias vote
    stage_rows_bf16<D>(kst + into * HT, kb, live * kTile, Nk);
    stage_rows_bf16<D>(vst + into * HT, vb, live * kTile, Nk);
    if (threadIdx.x < kTile) bst[into * kTile + threadIdx.x] = bval;
  };
  if (tile < nt) stage(tile, 0);
  cp_async_commit();
  while (tile < nt) {
    const int next = next_live_tile(biasb, Nk, nt, tile + 1, any_key, bval);
    if (next < nt) stage(next, buf ^ 1);  // the other buffer was released by the last barrier
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    dq_tile_bf16<D>(qt, ot, kst + buf * HT, vst + buf * HT, bst + buf * kTile, lse_r, delta_r,
                    dqa);
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

// dkv_tile on bf16 Q, K, V: S^T = K Q^T in one bf16 pass; dP^T = V dO^T and
// dK += dS^T Q in two TF32 passes (dO's and dS's big and small halves);
// dV += P^T dO in 3xTF32 (both fp32). V's fragments come packed from
// registers (vp), loaded once per CTA.
template <int D>
__device__ __forceinline__ void dkv_tile_bf16(const bf16* kt, uint32_t (*vp)[2],
                                              const bf16* qt, const float* ot, const float* lt,
                                              const float* dlt, const float* bias_r,
                                              float (*dka)[4], float (*dva)[4]) {
  constexpr int SH = D + kPadH, S = D + kPad, NH = 2, KS = D / 8;
  const int t = threadIdx.x & 3, r0 = (threadIdx.x >> 5) * 16;
#pragma unroll 1
  for (int part = 0; part < kTile / (8 * NH); ++part) {
    const int c0 = part * NH * 8;
    float sa[NH][4], pa[NH][4];
#pragma unroll
    for (int j = 0; j < NH; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[j][e] = pa[j][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t a[4], b[4];
      ldm_a<SH>(kt, r0, ks * 16, a);
      ldm_b_rows_n<SH>(qt, c0, ks * 16, b);
      mma_bf16(sa[0], a, b);
      mma_bf16(sa[1], a, b + 2);
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      unpack_a(vp[kk], a);
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        uint32_t bb[2], bs[2];
        load_b_rows_n<S>(ot, c0 + j * 8, kk * 8, bb, bs);
        mma2_split_b(pa[j], a, bb, bs);
      }
    }
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      const int col = c0 + j * 8 + 2 * t;
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
      uint32_t pb[4], ps[4], db[4], ds[4];
      a_from_c(sa[j], pb, ps);
      a_from_c(pa[j], db, ds);
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        uint32_t bb[2], bs[2];
        load_b_rows_k<S>(ot, c0 + j * 8, n * 8, bb, bs);
        mma3_add(dva[n], pb, ps, bb, bs);
      }
#pragma unroll
      for (int n = 0; n < KS; n += 4) {
        uint32_t b[8];
        ldm_b_rows_k_x4<SH>(qt, c0 + j * 8, n * 8, b);
#pragma unroll
        for (int m = 0; m < 4; ++m) mma2_split_a_add(dka[n + m], db, ds, b + 2 * m);
      }
    }
  }
}

// dkv_kernel on bf16 q, k, v: K, V and the swept Q tiles stay bf16 in
// shared memory, copied by cp.async, the swept ones double-buffered.
template <int D>
__global__ void __launch_bounds__(kThreads, kBf16DkvCtas<D>)
dkv_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ bias,
                const float* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int H, int Nq, int Nk) {
  constexpr int SH = D + kPadH, HT = kTile * SH, FT = kTile * (D + kPad), KS = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* ost = smem;                  // [2][FT] swept dO
  float* lst = ost + 2 * FT;          // [2][kTile] swept lse
  float* dlst = lst + 2 * kTile;      // [2][kTile] swept delta
  bf16* kt = reinterpret_cast<bf16*>(dlst + 2 * kTile);  // resident K
  bf16* vt = kt + HT;                 // resident V
  bf16* qst = vt + HT;                // [2][HT] swept Q

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

  const bf16* qb = q + bh * Nq * D;
  const float* ob = dout + bh * Nq * D;
  const float* lb = lse + bh * Nq;
  const float* db = delta + bh * Nq;
  const int nt = (Nq + kTile - 1) / kTile;
  // queries past Nq are zero with lse = delta = 0: their P multiplies a zero
  // dO row and their dS = P (0 - 0) = 0, so they add exactly nothing
  auto stage = [&](int tile, int into) {
    const int n0 = tile * kTile;
    stage_rows_bf16<D>(qst + into * HT, qb, n0, Nq);
    stage_rows<D>(ost + into * FT, ob, n0, Nq);
    stage_vec(lst + into * kTile, lb, n0, Nq);
    stage_vec(dlst + into * kTile, db, n0, Nq);
  };
  stage_rows_bf16<D>(kt, k + bh * Nk * D, k0, Nk);  // a group of its own: V's fragments
  stage_rows_bf16<D>(vt, v + bh * Nk * D, k0, Nk);  // are read before the sweep
  cp_async_commit();
  stage(0, 0);  // Nq >= 1
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
  cp_async_wait_all_but_one();  // K and V have landed
  __syncthreads();
  uint32_t vp[KS][2];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) load_a_packed<SH>(vt, r0, kk * 8, vp[kk]);

  for (int tile = 0, buf = 0; tile < nt; ++tile, buf ^= 1) {
    if (tile + 1 < nt) stage(tile + 1, buf ^ 1);  // released by the last barrier
    cp_async_commit();
    cp_async_wait_all_but_one();
    __syncthreads();
    dkv_tile_bf16<D>(kt, vp, qst + buf * HT, ost + buf * FT, lst + buf * kTile,
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
  constexpr bool is_bf16 = std::is_same_v<T, bf16>;  // the bf16 entry's kernel
  const auto kernel = [] {
    if constexpr (is_bf16) return dq_kernel_bf16<D>; else return dq_kernel<D>;
  }();
  const size_t smem = is_bf16 ? dq_bf16_smem_bytes<D>() : dq_smem_bytes<D>();
  const int set = allow_smem(kernel, smem);
  if (set) return set;
  const dim3 grid((Nq + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, s>>>(q, k, v, bias, dout, lse, delta, dq, H, Nq, Nk);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch_dkv(const T* q, const T* k, const T* v, const float* bias, const float* dout,
               const float* lse, const float* delta, float* dk, float* dv, int B, int H, int Nq,
               int Nk, cudaStream_t s) {
  constexpr bool is_bf16 = std::is_same_v<T, bf16>;
  const auto kernel = [] {
    if constexpr (is_bf16) return dkv_kernel_bf16<D>; else return dkv_kernel<D>;
  }();
  const size_t smem = is_bf16 ? dkv_bf16_smem_bytes<D>() : dkv_smem_bytes<D>();
  const int set = allow_smem(kernel, smem);
  if (set) return set;
  const dim3 grid((Nk + kTile - 1) / kTile, H, B);
  kernel<<<grid, kThreads, smem, s>>>(q, k, v, bias, dout, lse, delta, dk, dv, H, Nq, Nk);
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
// delta and the gradients stay fp32. The kernels are dq_kernel_bf16 and
// dkv_kernel_bf16 (see the header): they keep q, k, v in bf16 and run each
// product in the passes its operands need, so they do not give the _f32
// entries' bits on fp32 copies (Q K^T is summed in another order); they are
// held to the plain versions and to a float64 replay instead.
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

// The same for the bf16 entries' kernels.
extern "C" int imp_flash_bwd_layout_bf16(int D, int* tile, int* dq_smem, int* dkv_smem) {
  *tile = kTile;
  if (D == 32) {
    *dq_smem = static_cast<int>(dq_bf16_smem_bytes<32>());
    *dkv_smem = static_cast<int>(dkv_bf16_smem_bytes<32>());
  } else if (D == 64) {
    *dq_smem = static_cast<int>(dq_bf16_smem_bytes<64>());
    *dkv_smem = static_cast<int>(dkv_bf16_smem_bytes<64>());
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}
