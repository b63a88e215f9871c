// Device helpers shared by the kernel sources of this directory: the online
// softmax statistics, bf16 storage and stochastic rounding, the loss
// gradient of one element, asynchronous copies, the merges of per-split
// partials (rows; the (rows, k + 1) partials of project and dm_backward),
// the TF32 split and the tensor-core products (mma.sync, TF32 and bf16).
// Everything sits in an anonymous namespace, so each source
// that includes this file gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float NEG_BIG = -1e30f;
// Entries at or below PAD_GUARD are padding sentinels of the JAX package's
// sharded path: they take no L1/L2 norm and no norm gradient.
constexpr float PAD_GUARD = -1e20f;
constexpr float BETA1 = 0.9f;
constexpr float BETA2 = 0.999f;
constexpr float ONE_MINUS_BETA1 = 0.1f;    // f32(1.0 - 0.9)
constexpr float ONE_MINUS_BETA2 = 0.001f;  // f32(1.0 - 0.999)
constexpr float ADAM_EPS = 1e-8f;

// ---------------------------------------------------------------------------
// online softmax statistics: m = max, l = sum exp(x - m), u = sum exp(x - m) x
// ---------------------------------------------------------------------------

__device__ __forceinline__ void stats_push(float& m, float& l, float& u, float x) {
  if (x > m) {
    const float scale = expf(m - x);
    l = l * scale + 1.0f;
    u = u * scale + x;
    m = x;
  } else {
    const float e = expf(x - m);
    l += e;
    u = fmaf(e, x, u);
  }
}

__device__ __forceinline__ void stats_merge(float& m, float& l, float& u,
                                            float m2, float l2, float u2) {
  const float mn = fmaxf(m, m2);
  const float a = expf(m - mn);
  const float b = expf(m2 - mn);
  l = l * a + l2 * b;
  u = u * a + u2 * b;
  m = mn;
}

// merge over the lanes of an aligned group of `width` lanes (butterfly)
__device__ __forceinline__ void stats_reduce(float& m, float& l, float& u, int width) {
  for (int off = width / 2; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    const float u2 = __shfl_xor_sync(0xffffffffu, u, off);
    stats_merge(m, l, u, m2, l2, u2);
  }
}

// sum over the lanes of an aligned group of `width` lanes (butterfly)
__device__ __forceinline__ float sum_reduce(float v, int width) {
  for (int off = width / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the L1/L2 norm sums take real entries only: x > PAD_GUARD, else 0
__device__ __forceinline__ float norm_value(float x) { return x > PAD_GUARD ? x : 0.0f; }

__device__ __forceinline__ void norms_push(float& s1, float& s2, float x) {
  const float z = norm_value(x);
  s1 += fabsf(z);
  s2 = fmaf(z, z, s2);
}

// ---------------------------------------------------------------------------
// bf16 storage and stochastic rounding
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

// a bf16 is the upper half of an f32: widening is a shift, exact
__device__ __forceinline__ float bf16_bits_to_f32(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

// f32 -> bf16 -> f32, round to nearest even (jnp's astype)
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the JAX package's 32-bit Wang hash (fused_step.py::_wang_hash), mod 2^32
__device__ __forceinline__ uint32_t wang_hash(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x = x * 9u;
  x = x ^ (x >> 4);
  x = x * 0x27D4EB2Du;
  return x ^ (x >> 15);
}

// Stochastic-rounding key of one (step t, cell, array salt): JAX's per-tile
// seed with the tile taken as one cell row, base = wang(t ^ cell 0x85EBCA6B),
// then _tile_random_bits' key wang((base ^ salt) 0x9E3779B9). The bits of
// entry (cell, spot) are wang(spot ^ key): they depend on no tiling, so the
// kernels and their twin draw the same bits for the same f32 value.
__device__ __forceinline__ uint32_t sr_key(uint32_t t, uint32_t cell, uint32_t salt) {
  const uint32_t base = wang_hash(t ^ (cell * 0x85EBCA6Bu));
  return wang_hash((base ^ salt) * 0x9E3779B9u);
}

// what an entry of f32 value v keeps when stored: v itself in f32 storage;
// in bf16 the nearest-even bf16, or (sr) the bf16 that _sr_cast gives: add
// 16 random bits below the bf16 mantissa and truncate (unbiased). The
// result is an exact bf16, returned as f32.
__device__ __forceinline__ float stored_value(float v, bool bf16_store, bool sr,
                                              uint32_t key, int spot) {
  if (!bf16_store) return v;
  if (!sr) return round_bf16(v);
  const uint32_t bits = wang_hash((uint32_t)spot ^ key);
  return __uint_as_float((__float_as_uint(v) + (bits & 0xFFFFu)) & 0xFFFF0000u);
}

// 16-byte asynchronous copy global -> shared (both 16-byte aligned);
// valid == false writes zeros
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

// asynchronous copy global -> shared of the first src_bytes (0..BYTES) of
// BYTES bytes (4, 8 or 16; both addresses aligned to BYTES); the rest reads
// zero
template <int BYTES>
__device__ __forceinline__ void cp_async_part(void* smem, const void* gmem, int src_bytes) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(gmem),
                 "n"(BYTES), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the loss gradient of one element: softmax VJP plus the L1/L2 terms on the
// raw logit; sign(0) = 0 as jnp.sign gives, and sentinels take no norm term
__device__ __forceinline__ float grad_elem(float P, float dP, float r, float x,
                                           float lam1, float two_lam2, bool norm_grad) {
  float g = P * (dP - r);
  if (norm_grad) {
    const float z = norm_value(x);
    const float sgn = (float)((z > 0.0f) - (z < 0.0f));
    g = g + lam1 * sgn;
    g = g + two_lam2 * z;
  }
  return g;
}

// In split order, (nsplit, c) partials -> (c,) outputs:
//   !STATS: out0 = the sum of the row partials (r or vr);
//   STATS:  (out0, out1, out2) = the online-stats merge of (m, l, u) and,
//           with NORMS, (out3, out4) = the sums of s1 and s2.
template <bool STATS, bool NORMS>
__global__ void dp_merge_kernel(const float* __restrict__ part, float* __restrict__ out0,
                                float* __restrict__ out1, float* __restrict__ out2,
                                float* __restrict__ out3, float* __restrict__ out4, int c,
                                int nsplit) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= c) return;
  if (!STATS) {
    float acc = 0.0f;
    for (int z = 0; z < nsplit; ++z) acc += part[(size_t)z * c + cell];
    out0[cell] = acc;
    return;
  }
  const size_t plane = (size_t)nsplit * c;
  float mm = NEG_BIG, ll = 0.0f, uu = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int z = 0; z < nsplit; ++z) {
    const size_t e = (size_t)z * c + cell;
    stats_merge(mm, ll, uu, part[e], part[plane + e], part[2 * plane + e]);
    if (NORMS) {
      s1 += part[3 * plane + e];
      s2 += part[4 * plane + e];
    }
  }
  out0[cell] = mm;
  out1[cell] = ll;
  out2[cell] = uu;
  if (NORMS) {
    out3[cell] = s1;
    out4[cell] = s2;
  }
}


// ---------------------------------------------------------------------------
// f32 products on the tensor cores (3xTF32) and bf16 products
// ---------------------------------------------------------------------------

// x = hi + lo exactly: hi is x rounded to TF32's 11 significant bits, by
// Veltkamp's product (8193 x - 8192 x, the first rounded to f32, the
// difference exact), and lo = x - hi has at most 12, of which the tensor
// core drops the last (it ignores an operand's low 13 bits): 2^-22 of x.
// Three full-rate FMA-pipe instructions; cvt.rna.tf32.f32 gives the same hi
// up to ties, but two of them per operand held the whole kernel to the
// conversion unit's rate (3.3 ms of the product loop at the tutorial shape).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const float h = __fmaf_rn(x, -8192.0f, __fmul_rn(x, 8193.0f));
  hi = __float_as_uint(h);
  lo = __float_as_uint(__fsub_rn(x, h));
}

// d += a b: a 16 x 8 (row-major fragment), b 8 x 8 (column fragment), TF32
// operands, f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b: the first product of a chain, onto zero
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

// d = a b: a 16 x 16 (row-major fragment), b 16 x 8 (column fragment), bf16
// operands (two to a register, the lower k in the lower half), f32
// accumulation; the products are exact, the first of a chain onto zero
__device__ __forceinline__ void mma_bf16_first(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}


// The sum over the splits of a (nsplit, rows, k + 1) partial, in split
// order, split into its first k columns X (rows, k) and its last v (rows,):
// Y and q for project, dA and dw for dm_backward.
__global__ void ext_reduce_kernel(const float* __restrict__ partial,
                                  float* __restrict__ X, float* __restrict__ v,
                                  int rows, int k, int nsplit) {
  const int K1 = k + 1;
  const size_t n = (size_t)rows * K1;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int z = 0; z < nsplit; ++z) acc += partial[(size_t)z * n + e];
    const size_t row = e / K1;
    const int col = (int)(e % K1);
    if (col < k) X[row * k + col] = acc;
    else v[row] = acc;
  }
}

cudaError_t launch_ext_reduce(const float* partial, float* X, float* v, int rows, int k,
                              int nsplit, cudaStream_t st) {
  const size_t n = (size_t)rows * (k + 1);
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  ext_reduce_kernel<<<blocks, 256, 0, st>>>(partial, X, v, rows, k, nsplit);
  return cudaGetLastError();
}

}  // namespace
