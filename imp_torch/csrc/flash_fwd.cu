// Masked flash-attention forward for Hopper (sm_90a) (K1): q, k, v in fp32
// (imp_flash_fwd_f32) or bf16 (imp_flash_fwd_bf16); bias, O and lse fp32.
//
// Replaces the Pallas TPU kernel imp_tpu/ops/flash_attention.py::_make_fwd_kernel
// (launched by _fwd_impl). Same contract: for pre-scaled q and an additive
// key-bias row (0 valid / -1e30 masked) it returns
//   O[b,h,i,:] = sum_j softmax_j(q_i . k_j + bias_j) v_j   and
//   lse[b,h,i] = logsumexp_j(q_i . k_j + bias_j).
// A query row whose keys are all masked sees equal scores (-1e30 absorbs the
// dot product), so it returns the mean of V and lse ~ -1e30: finite, as on
// the TPU, for the caller to mask downstream. Keys past Nk (the ragged edge
// of the last tile) are excluded here, so the caller pads nothing.
//
// What bounds it on the H100: 4*B*H*Nq*Nk*d FLOPs (QK^T and PV) plus
// B*H*Nq*Nk exps, against q, k, v and O read or written once: compute-bound.
// Both products run on the tensor cores in 3xTF32 (tf32x3.cuh), whose
// ceiling is a third of the 494.7 TFLOP/s TF32 peak: at TransMIL's bag
// (N = 10 001, 7 314 valid keys, d = 64, 8 heads) ~0.91 ms, where the
// 67 TFLOP/s fp32 CUDA cores would need 2.24 ms.
//
// Design (K2's, flash_bwd.cu, with an online softmax):
//  * A CTA of 4 warps owns 64 query rows of one (b, h); each warp owns 16.
//    Q stays resident in shared memory; the CTA sweeps key tiles of 64,
//    whose K, V and bias are double-buffered with cp.async, so tile t + 1
//    loads while tile t computes. Rows are padded to d + 4 floats.
//  * S = Q K^T per warp (16 x 64) in 3xTF32 mma.sync; the bias is added in
//    the accumulator layout, where each lane holds 2 columns of rows g and
//    g + 8. The online softmax runs there: the tile's row max is reduced
//    over the lane quad that shares a row, then m_new, alpha = exp(m - m_new)
//    and P = exp(s - m_new); each lane keeps its own partial of the row sum
//    l and the quad adds them only at the end.
//  * P feeds O += P V as the A operand straight from the accumulator (keys
//    in the order 0,2,4,6,1,3,5,7, V's rows read in that order). The tile's
//    part of O is formed in a fresh accumulator and added as
//    o = o * alpha + part in fp32: the long sum over thousands of keys never
//    stays in the tensor core's accumulator, whose adds lose precision.
//  * In a slide with a valid key, a 64-key tile whose biases are all masked
//    is skipped without being loaded (a block vote per tile, never from a
//    length): every row's max there is far above -1e30, so such a key has
//    P = 0 exactly. A slide with no valid key sweeps every key.
//  * The bias of a key past Nk is set to -inf explicitly (cp.async fills
//    zeros, which would read as a valid key), so it gets P = 0.
//
//  * The bf16 entry (TRAINER.PREC bf16: the TPU kernel's contract under
//    mxu_precision="fp32", q, k, v read as bf16 and widened in the kernel
//    body) widens q, k and v exactly to fp32 as it stages them
//    (tf32x3.cuh), so its shared tiles and arithmetic are the fp32 entry's
//    and it gives the fp32 entry's bits on widened copies. It moves half the
//    operand bytes for the same products. A bf16 value has a zero low TF32
//    split, so two of its three Q.K^T passes add zeros: using that is left
//    for later (ROADMAP §B item 3).
//
// Left for later: wgmma with TMA, warp specialisation, persistent CTAs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

// one key tile for this warp's 16 query rows: S = Q K^T + bias, the online
// softmax update of (m, l), and o = o * alpha + P V. m and l hold rows g
// and g + 8 of the warp; l is this lane's partial over its own columns.
template <int D>
__device__ __forceinline__ void fwd_tile(const float* qt, const float* kt, const float* vt,
                                         const float* bt, float* m, float* l,
                                         float (*oa)[4]) {
  constexpr int S = D + kPad, NT = kTile / 8, KS = D / 8;
  const int t = threadIdx.x & 3, r0 = (threadIdx.x >> 5) * 16;
  float sa[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sa[j][e] = 0.f;
  }
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t qab[4], qas[4];
    load_a<S>(qt, r0, ks * 8, qab, qas);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bb[2], bs[2];
      load_b_rows_n<S>(kt, j * 8, ks * 8, bb, bs);
      mma3(sa[j], qab, qas, bb, bs);
    }
  }
  float mt[2] = {-INFINITY, -INFINITY};  // the tile's row max
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 bias2 = *reinterpret_cast<const float2*>(bt + j * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sa[j][e] += (e & 1) ? bias2.y : bias2.x;
      mt[e >> 1] = fmaxf(mt[e >> 1], sa[j][e]);
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
    mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
    // every swept tile holds a key with a finite score, so m_new is finite
    // and alpha = exp(-inf - m_new) = 0 on the first tile
    const float m_new = fmaxf(m[i], mt[i]);
    alpha[i] = expf(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(sa[j][e] - m[e >> 1]);
      sa[j][e] = p;
      l[e >> 1] += p;
    }
  }
  float part[KS][4];  // this key tile's part of O, added to O in fp32
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
      load_b_rows_k<S>(vt, j * 8, n * 8, bb, bs);
      mma3(part[n], ab, as, bb, bs);
    }
  }
#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) oa[n][e] = oa[n][e] * alpha[e >> 1] + part[n][e];
  }
}

// One CTA per (b, h, tile of kTile queries); sweeps the live key tiles.
// T is the element type of q, k and v (float or __nv_bfloat16).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse, int H, int Nq, int Nk) {
  constexpr int S = D + kPad, TILE = kTile * S, KS = D / 8;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;             // resident Q
  float* kst = qt + TILE;       // [2][TILE] swept K
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

  // lands with the first key tile; queries past Nq are zero and never stored
  stage_rows<D>(qt, q + bh * Nq * D, q0, Nq);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float oa[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) oa[n][e] = 0.f;
  }

  const bool any_key = slide_has_key(biasb, Nk);
  float bval = -INFINITY;
  // keys past Nk are zero with bias -inf (set here, not by cp.async): P = 0
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
    fwd_tile<D>(qt, kst + buf * TILE, vst + buf * TILE, bst + buf * kTile, m, l, oa);
    __syncthreads();  // the next stage overwrites this buffer
    buf ^= 1;
    tile = next;
  }

  float* ob = o + bh * Nq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + r0 + g + 8 * i;
    if (row < Nq) {
      const float inv = 1.f / l[i];  // l >= 1: the max score contributes exp(0)
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        *reinterpret_cast<float2*>(ob + (size_t)row * D + n * 8 + 2 * t4) =
            make_float2(oa[n][2 * i] * inv, oa[n][2 * i + 1] * inv);
      }
      if (t4 == 0) lse[bh * Nq + row] = m[i] + logf(l[i]);
    }
  }
}

// dynamic shared memory: resident Q, double-buffered K and V, and the
// double-buffered bias: 87 552 bytes at d = 64, so two CTAs share an SM
template <int D>
constexpr size_t fwd_smem_bytes() {
  return (5 * kTile * (D + kPad) + 2 * kTile) * sizeof(float);
}

template <int D, typename T>
int launch_fwd(const T* q, const T* k, const T* v, const float* bias, float* o, float* lse,
               int B, int H, int Nq, int Nk, cudaStream_t s) {
  const int set = allow_smem(flash_fwd_kernel<D, T>, fwd_smem_bytes<D>());
  if (set) return set;
  const dim3 grid((Nq + kTile - 1) / kTile, H, B);
  flash_fwd_kernel<D, T><<<grid, kThreads, fwd_smem_bytes<D>(), s>>>(q, k, v, bias, o, lse,
                                                                     H, Nq, Nk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fwd_entry(const T* q, const T* k, const T* v, const float* bias, float* o, float* lse,
              int B, int H, int Nq, int Nk, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch_fwd<32>(q, k, v, bias, o, lse, B, H, Nq, Nk, s);
  if (D == 64) return launch_fwd<64>(q, k, v, bias, o, lse, B, H, Nq, Nk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q [B,H,Nq,D], k/v [B,H,Nk,D], bias [B,Nk], o [B,H,Nq,D], lse [B,H,Nq]:
// contiguous fp32, 16-byte aligned, Nq >= 1, Nk >= 1, D in {32, 64}.
// Launches on `stream` and returns the cudaError_t of the shared-memory
// attribute or of the launch (0 = launched).
extern "C" int imp_flash_fwd_f32(const float* q, const float* k, const float* v,
                                 const float* bias, float* o, float* lse,
                                 int B, int H, int Nq, int Nk, int D,
                                 void* stream) {
  return fwd_entry(q, k, v, bias, o, lse, B, H, Nq, Nk, D, stream);
}

// The same with q, k, v in bf16 (contiguous, 16-byte aligned); bias, o and
// lse stay fp32. Gives imp_flash_fwd_f32's bits on fp32 copies of q, k, v.
extern "C" int imp_flash_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                  const __nv_bfloat16* v, const float* bias, float* o,
                                  float* lse, int B, int H, int Nq, int Nk, int D,
                                  void* stream) {
  return fwd_entry(q, k, v, bias, o, lse, B, H, Nq, Nk, D, stream);
}

// The launch layout, for reports and tests: the rows a CTA owns and the keys
// it sweeps per tile (masked key tiles are skipped a tile at a time), and
// the kernel's dynamic shared memory in bytes at head width D.
extern "C" int imp_flash_fwd_layout(int D, int* tile, int* smem) {
  *tile = kTile;
  if (D == 32) {
    *smem = static_cast<int>(fwd_smem_bytes<32>());
  } else if (D == 64) {
    *smem = static_cast<int>(fwd_smem_bytes<64>());
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}
