// Primitives shared by the 3xTF32 tensor-core kernels for Hopper (sm_90a):
// the flash-attention kernels K1 (flash_fwd.cu) and K2/K3 (flash_bwd.cu),
// and the modularity passes K4/K5 (modularity.cu: split, mma3,
// load_b_rows_n, the cp.async copies, stage_vec and allow_smem; their
// resident row tile has a run-time stride, so they form A fragments as
// load_a does, in place).
//
//  * 3xTF32 tensor-core products: an fp32 operand x is split into
//    big = x rounded to TF32 and small = x - big, and
//    a.b = big.big + big.small + small.big on mma.sync.m16n8k8 (fp32
//    accumulate), which keeps fp32 accuracy; the fragment loaders split
//    as they load from row-major shared tiles padded to D + kPad floats.
//  * cp.async staging of kTile-row tiles and vectors (zero past the end);
//    bf16 rows (K1's bf16 entry) are read by plain loads and widened to
//    fp32 as they are staged, so the shared tiles and every product are
//    those of the fp32 entry. K2/K3's bf16 entries keep bf16 tiles
//    (bf16mma.cuh).
//  * the masked-key-tile vote: a bias at or below kMaskedBelow is a masked key.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // 4 warps, 16 output rows each
constexpr int kTile = 64;       // output rows per CTA and rows per swept tile
constexpr int kPad = 4;         // floats of padding per shared row
constexpr float kMaskedBelow = -1e29f;  // a bias at or below this is a masked key

// ---------------------------------------------------------------------------
// 3xTF32 tensor-core products
// ---------------------------------------------------------------------------

// x = big + small. big is x rounded to the nearest TF32 value, ties away
// from zero: what cvt.rna.tf32.f32 gives for a finite x, in two integer
// operations (on sm_90a ptxas wraps the rounding of cvt.rna.tf32.f32 in a
// finiteness test and a select, which took most of the split's cost). small =
// x - big is exact in fp32 and goes to the tensor core as it is, which reads
// the top 19 bits of a TF32 operand: small is truncated, an error of at most
// 2^-21 |x|. This is the split of CUTLASS's fast-fp32 tensor-op MMA.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c[16x8] += a[16x8] . b[8x8], TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b in 3xTF32 (the small . small term is below fp32 rounding)
__device__ __forceinline__ void mma3(float* c, const uint32_t* ab, const uint32_t* as,
                                     const uint32_t* bb, const uint32_t* bs) {
  mma_tf32(c, ab, bs);
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bb);
}

// the same, formed apart and added to c by an fp32 add (K3's long sums)
__device__ __forceinline__ void mma3_add(float* c, const uint32_t* ab, const uint32_t* as,
                                         const uint32_t* bb, const uint32_t* bs) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, ab, as, bb, bs);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// Fragment loads from a row-major shared tile with row stride S. Lane
// (g = lane / 4, t = lane % 4) holds, for m16n8k8:
//   A: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
//   B: (k = t, n = g), (k = t + 4, n = g)
//   C: (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)

// A fragment of rows [r0, r0 + 16), columns [k0, k0 + 8)
template <int S>
__device__ __forceinline__ void load_a(const float* tile, int r0, int k0, uint32_t* ab,
                                       uint32_t* as) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (r0 + g) * S + k0 + t;
  split(p[0], ab[0], as[0]);
  split(p[8 * S], ab[1], as[1]);
  split(p[4], ab[2], as[2]);
  split(p[8 * S + 4], ab[3], as[3]);
}

// B fragment for X . T^T: n = rows [n0, n0 + 8) of T, k = columns [k0, k0 + 8)
template <int S>
__device__ __forceinline__ void load_b_rows_n(const float* tile, int n0, int k0, uint32_t* bb,
                                              uint32_t* bs) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (n0 + g) * S + k0 + t;
  split(p[0], bb[0], bs[0]);
  split(p[4], bb[1], bs[1]);
}

// B fragment for X . T: k = rows [k0, k0 + 8) of T in the order 0,2,4,6,
// 1,3,5,7 (that of a_from_c), n = columns [n0, n0 + 8)
template <int S>
__device__ __forceinline__ void load_b_rows_k(const float* tile, int k0, int n0, uint32_t* bb,
                                              uint32_t* bs) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = tile + (k0 + 2 * t) * S + n0 + g;
  split(p[0], bb[0], bs[0]);
  split(p[S], bb[1], bs[1]);
}

// An accumulator fragment (16 rows x 8 columns) as the A operand of the
// next product, its 8 columns taken in the order 0,2,4,6,1,3,5,7
__device__ __forceinline__ void a_from_c(const float* c, uint32_t* ab, uint32_t* as) {
  split(c[0], ab[0], as[0]);
  split(c[2], ab[1], as[1]);
  split(c[1], ab[2], as[2]);
  split(c[3], ab[3], as[3]);
}

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group (the newest) is in flight
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows [r0, r0 + kTile) of a [n, D] matrix into a padded shared tile, zero
// past n (cp.async with source size 0 fills zeros and reads nothing)
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int r0, int n) {
  constexpr int C = D / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const bool in = r0 + r < n;
    cp_async16(dst + r * (D + kPad) + 4 * c, in ? src + (size_t)(r0 + r) * D + 4 * c : src, in);
  }
}

// the same from a bf16 [n, D] matrix: four elements (8 bytes) per thread
// and chunk, each widened exactly to fp32 (a bf16 value is the top half of
// its fp32 value) and stored as one float4, so the staged tile holds the
// bits that the fp32 staging of a widened copy would. Plain loads, not
// cp.async: the widening needs the values in registers, so these loads
// complete before the call returns and overlap only each other.
template <int D>
__device__ __forceinline__ void stage_rows(float* dst, const __nv_bfloat16* src, int r0, int n) {
  constexpr int C = D / 4;  // 4-element chunks per row
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    const int r = i / C, c = i % C;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) {
      const uint2 w = *reinterpret_cast<const uint2*>(src + (size_t)(r0 + r) * D + 4 * c);
      f = make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                      __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
    }
    *reinterpret_cast<float4*>(dst + r * (D + kPad) + 4 * c) = f;
  }
}

// kTile entries [r0, r0 + kTile) of a vector, zero past n
__device__ __forceinline__ void stage_vec(float* dst, const float* src, int r0, int n) {
  if (threadIdx.x < kTile) {
    const bool in = r0 + threadIdx.x < n;
    cp_async4(dst + threadIdx.x, in ? src + r0 + threadIdx.x : src, in);
  }
}

// ---------------------------------------------------------------------------
// masked key tiles
// ---------------------------------------------------------------------------

// whether the slide's bias row [n] has a valid key (a block vote; uniform)
__device__ bool slide_has_key(const float* bias, int n) {
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + threadIdx.x;
    if (__syncthreads_or(i < n && bias[i] > kMaskedBelow)) return true;
  }
  return false;
}

// the first key tile from `t` on that K1 or K2 must sweep: any tile where the
// slide has no valid key, else one with a valid key; nt when none is left.
// Threads < kTile get the tile's bias entry in `bval` (-inf past n).
__device__ int next_live_tile(const float* bias, int n, int nt, int t, bool any_key,
                              float& bval) {
  for (; t < nt; ++t) {
    const int i = t * kTile + threadIdx.x;
    const float bv = threadIdx.x < kTile && i < n ? bias[i] : -INFINITY;
    if (__syncthreads_or(!any_key || bv > kMaskedBelow)) {
      bval = bv;
      return t;
    }
  }
  return nt;
}

// raise a kernel's dynamic shared memory limit above 48 KB and ask for the
// largest shared-memory carveout, so that two CTAs fit an SM. Attributes are
// set per device, so this runs before every launch, on the current device.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  return static_cast<int>(err);
}

}  // namespace
