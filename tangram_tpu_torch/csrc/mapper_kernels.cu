// Hand-written Hopper (sm_90a) kernels for the fused mapping step.
//
// The fused Tangram step streams the (cells x spots) logits M through a few
// passes and never stores the softmax P = softmax(M, rows) or its cotangent
// dP:
//
//   tg_rowstats         per-cell online softmax stats m, l, u       (init only;
//                                                          every autograd step)
//   tg_rowstats_norms   the same plus s1 = sum |M|, s2 = sum M^2    (init, L1/L2)
//   tg_project          Y = P^T A and q = w P                      (every step)
//                       (project_tc_kernels.cu)
//   tg_rbar             r_c = sum_s P * dP                         (every step)
//   tg_dm_adam          g = P (dP - r) [+ L1/L2 gradient], exact Adam in
//                       place on M/mu/nu, and the next step's m, l, u
//                       [, s1, s2]                                 (Adam steps)
//   tg_gsq_tc           sum_s g^2 per cell and sum_c g^2 per spot  (Adafactor)
//   tg_dm_adafactor_tc  M -= lr g rowf[c] colf[s] in place, and the next
//                       step's m, l, u [, s1, s2]                  (Adafactor)
//   tg_dm_backward_tc   dM = P (dP - r) and [dA | dw] = P [dY | dq], the
//                       backward of the unfused core              (autograd)
//
// with dP = A dY^T + w (x) dq [+ dh (x) (log P + 1)] formed tile by tile.
// Each kernel replaces one Pallas TPU kernel of the JAX package (named at
// each kernel). The TPU grid carries sums from one grid step to the next in
// VMEM; here a loop inside the block takes that place, and every
// cross-thread reduction has a fixed order, so all kernels are
// deterministic (no atomics).
//
// This file holds the row stats; the kernels of the dP tile (tg_rbar,
// tg_gsq_tc, tg_dm_adam, tg_dm_adafactor_tc, tg_dm_backward_tc) are in
// dp_tensor_kernels.cu, on the tensor cores, and tg_project in
// project_tc_kernels.cu, on the tensor cores too; common.cuh holds what
// they share. Every entry point launches on the given stream, does not
// synchronise, allocates nothing and returns cudaGetLastError() so the
// caller can raise on a refused launch.

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// rowstats — replaces tangram_tpu/ops/pallas_core.py::_rowstats;
// rowstats<NORMS> replaces tangram_tpu/ops/fused_step.py::_rowstats_norms
//
// Per cell: m = max, l = sum exp(M - m), u = sum exp(M - m) M, and with
// NORMS s1 = sum |M| and s2 = sum M^2 over M > PAD_GUARD. M is f32 or bf16
// (TM); every sum is f32.
//
// Bound: one read of M (1.02 GB at the 26,000 x 9,852 tutorial shape in
// f32, 0.51 GB in bf16: 0.31 and 0.15 ms at 3.35 TB/s). The card keeps that
// rate only with enough bytes in flight, and in bf16 the arithmetic per
// byte (an exp, a max, two adds per entry) comes close to the SMs' issue
// rate. So the kernel is a pure stream over M:
//  * One warp per cell row, lanes on neighbouring addresses. Each lane
//    issues RS_LOADS independent loads of BYTES bytes before it uses any of
//    them: 16 bytes (4 f32 or 8 bf16) where the row length in bytes and
//    M's base allow, else 8 (a bf16 row of 9,852 entries is 19,704 bytes,
//    so only every other row starts 16-aligned), 4, or for a bf16 row of
//    odd length one entry (2 bytes). The wrapper picks BYTES by shape and
//    alignment. A load never straddles the row's end, since BYTES divides
//    the row, so the ragged last step masks whole loads.
//  * The next step's loads are issued before this step's entries are
//    summed, so every warp keeps loads in flight while it computes (a warp
//    that loads and then computes leaves M at 2.4 TB/s in f32, 1.7 in bf16,
//    on the H100).
//  * Per step of RS_LOADS loads, one max over its entries, a rescale of l
//    and u only when that max rises, then one exp per entry against the
//    running max: the order of the JAX kernel (a tile's max, then its exps),
//    with no branch per entry. The exp is 2^(d log2 e) on the SFU
//    (exp_nonpos).
//  * The lanes merge their (m, l, u) [and s1, s2] by butterfly, in a fixed
//    order, so repeats give the same bits.
// ---------------------------------------------------------------------------

constexpr int RS_THREADS = 256;
constexpr int RS_LOADS = 4;  // independent loads in flight per lane

// the 32-bit words of one BYTES-wide load at p (aligned to BYTES); a 2-byte
// load fills the lower half of w[0]
template <int BYTES>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[BYTES >= 4 ? BYTES / 4 : 1]) {
  static_assert(BYTES == 16 || BYTES == 8 || BYTES == 4 || BYTES == 2, "a load width");
  if constexpr (BYTES == 16) {
    const uint4 t = __ldg(static_cast<const uint4*>(p));
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else if constexpr (BYTES == 8) {
    const uint2 t = __ldg(static_cast<const uint2*>(p));
    w[0] = t.x; w[1] = t.y;
  } else if constexpr (BYTES == 4) {
    w[0] = __ldg(static_cast<const unsigned int*>(p));
  } else {
    w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
}

// those words as the load's entries of type TM, in f32
template <typename TM, int BYTES>
__device__ __forceinline__ void unpack(const uint32_t (&w)[BYTES >= 4 ? BYTES / 4 : 1],
                                       float (&x)[BYTES / sizeof(TM)]) {
  static_assert(BYTES >= (int)sizeof(TM), "a load of whole entries");
  if constexpr (sizeof(TM) == 4) {
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) x[i] = __uint_as_float(w[i]);
  } else if constexpr (BYTES == 2) {
    x[0] = bf16_bits_to_f32(w[0]);
  } else {
    // two bf16 to a word, the lower address in the lower half
#pragma unroll
    for (int i = 0; i < BYTES / 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
}

// e^d for d <= 0 as 2^(d log2 e) on the SFU (ex2.approx, subnormal results
// flushed to 0): two instructions where expf takes eight, which in bf16 hold
// the stream to the SMs' issue rate. The product's rounding moves e^d by at
// most |d| 2^-24 relative and ex2 by 2^-22, a few f32 ulps for the entries
// that carry the sums; an entry with d < -126 ln 2 weighs below 2^-126.
__device__ __forceinline__ float exp_nonpos(float d) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(d * 1.44269504088896341f));
  return y;
}

// Add one step's entries x (load v valid where ok[v]; all when !MASKED) to
// this lane's online stats: the step's max first, then one exp per entry.
template <bool NORMS, bool MASKED, int L, int N>
__device__ __forceinline__ void stats_push_step(float& m, float& l, float& u, float& s1,
                                                float& s2, const float (&x)[L][N],
                                                const bool (&ok)[L]) {
  float top = NEG_BIG;
#pragma unroll
  for (int v = 0; v < L; ++v)
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (!MASKED || ok[v]) top = fmaxf(top, x[v][i]);
  if (top > m) {
    const float scale = exp_nonpos(m - top);
    l *= scale;
    u *= scale;
    m = top;
  }
  // two partial sums each, so the exps of a step do not wait on one another
  float ls[2] = {0.0f, 0.0f}, us[2] = {0.0f, 0.0f};
#pragma unroll
  for (int v = 0; v < L; ++v)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (MASKED && !ok[v]) continue;
      const int h = (v * N + i) & 1;
      const float e = exp_nonpos(x[v][i] - m);
      ls[h] += e;
      us[h] = fmaf(e, x[v][i], us[h]);
      if (NORMS) norms_push(s1, s2, x[v][i]);
    }
  l += ls[0] + ls[1];
  u += us[0] + us[1];
}

// 4 blocks of 256 threads per SM (64 registers a thread) hold a step's 16
// entries and the next step's words; a step of 32 (16-byte loads of bf16)
// takes 3 and 85 registers, or its entries spill
template <bool NORMS, typename TM, int BYTES>
__global__ void __launch_bounds__(RS_THREADS,
                                  RS_LOADS * BYTES / sizeof(TM) > 16 ? 3 : 4)
rowstats_kernel(const TM* __restrict__ M, float* __restrict__ m_out,
                float* __restrict__ l_out, float* __restrict__ u_out,
                float* __restrict__ s1_out, float* __restrict__ s2_out, int c, int s) {
  constexpr int N = BYTES / sizeof(TM);    // entries per load
  constexpr int W = BYTES >= 4 ? BYTES / 4 : 1;  // words per load
  constexpr int STEP = 32 * RS_LOADS * N;  // entries per warp per step
  const int row = (blockIdx.x * RS_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= c) return;  // the whole warp leaves together
  const TM* Mrow = M + (size_t)row * s;
  float m = NEG_BIG, l = 0.0f, u = 0.0f, s1 = 0.0f, s2 = 0.0f;
  float x[RS_LOADS][N];
  uint32_t raw[RS_LOADS][W];
  const bool all[RS_LOADS] = {true, true, true, true};
  static_assert(RS_LOADS == 4, "all[] lists every load");
  // load v of this lane in the step at j0: entries j0 + (v * 32 + lane) N ..
  const int full = s / STEP * STEP;
  if (full > 0) {
#pragma unroll
    for (int v = 0; v < RS_LOADS; ++v) load_words<BYTES>(Mrow + (v * 32 + lane) * N, raw[v]);
  }
  for (int j0 = 0; j0 < full; j0 += STEP) {
#pragma unroll
    for (int v = 0; v < RS_LOADS; ++v) unpack<TM, BYTES>(raw[v], x[v]);
    // the next step's loads fly while this one's entries are summed
    if (j0 + STEP < full) {
#pragma unroll
      for (int v = 0; v < RS_LOADS; ++v)
        load_words<BYTES>(Mrow + j0 + STEP + (v * 32 + lane) * N, raw[v]);
    }
    stats_push_step<NORMS, false>(m, l, u, s1, s2, x, all);
  }
  if (full < s) {
    bool ok[RS_LOADS];
#pragma unroll
    for (int v = 0; v < RS_LOADS; ++v) {
      const int at = full + (v * 32 + lane) * N;
      ok[v] = at < s;  // then the whole load lies in the row
      if (ok[v]) {
        load_words<BYTES>(Mrow + at, raw[v]);
        unpack<TM, BYTES>(raw[v], x[v]);
      }
    }
    stats_push_step<NORMS, true>(m, l, u, s1, s2, x, ok);
  }
  stats_reduce(m, l, u, 32);
  if (NORMS) {
    s1 = sum_reduce(s1, 32);
    s2 = sum_reduce(s2, 32);
  }
  if (lane == 0) {
    m_out[row] = m;
    l_out[row] = l;
    u_out[row] = u;
    if (NORMS) {
      s1_out[row] = s1;
      s2_out[row] = s2;
    }
  }
}

template <bool NORMS, typename TM>
cudaError_t launch_rowstats_typed(const void* M, float* m, float* l, float* u, float* s1,
                                  float* s2, int c, int s, int load_bytes, cudaStream_t st) {
  const dim3 grid((c + RS_THREADS / 32 - 1) / (RS_THREADS / 32));
  const TM* Mt = static_cast<const TM*>(M);
  switch (load_bytes) {
    case 16:
      rowstats_kernel<NORMS, TM, 16><<<grid, RS_THREADS, 0, st>>>(Mt, m, l, u, s1, s2, c, s);
      break;
    case 8:
      rowstats_kernel<NORMS, TM, 8><<<grid, RS_THREADS, 0, st>>>(Mt, m, l, u, s1, s2, c, s);
      break;
    case 4:
      rowstats_kernel<NORMS, TM, 4><<<grid, RS_THREADS, 0, st>>>(Mt, m, l, u, s1, s2, c, s);
      break;
    default:  // 2: a bf16 entry at a time
      if constexpr (sizeof(TM) == 2)
        rowstats_kernel<NORMS, TM, 2><<<grid, RS_THREADS, 0, st>>>(Mt, m, l, u, s1, s2, c, s);
      else
        return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool NORMS>
cudaError_t launch_rowstats(const void* M, float* m, float* l, float* u, float* s1,
                            float* s2, int c, int s, int m_bf16, int load_bytes,
                            cudaStream_t st) {
  const int esz = m_bf16 ? 2 : 4;
  const bool known = load_bytes == 16 || load_bytes == 8 || load_bytes == 4 || load_bytes == 2;
  if (!known || load_bytes < esz || ((size_t)s * esz) % load_bytes != 0 ||
      reinterpret_cast<uintptr_t>(M) % load_bytes != 0)
    return cudaErrorInvalidValue;
  return m_bf16 ? launch_rowstats_typed<NORMS, bf16>(M, m, l, u, s1, s2, c, s, load_bytes, st)
                : launch_rowstats_typed<NORMS, float>(M, m, l, u, s1, s2, c, s, load_bytes, st);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes). Each returns the cudaError_t of its
// launches; 0 means the kernels were enqueued.
//
// M: (c, s), f32 or (m_bf16) bf16; m, l, u [, s1, s2]: (c,) f32. load_bytes:
// the bytes of each load along a row, 16, 8, 4 or (bf16 only) 2; it must
// divide the row's length in bytes and M's base address.
// ---------------------------------------------------------------------------

extern "C" int tg_rowstats(const void* M, float* m, float* l, float* u, int c, int s,
                           int m_bf16, int load_bytes, void* stream) {
  return (int)launch_rowstats<false>(M, m, l, u, nullptr, nullptr, c, s, m_bf16, load_bytes,
                                     (cudaStream_t)stream);
}

// as tg_rowstats, plus s1 = sum |M| and s2 = sum M^2 over M > PAD_GUARD
extern "C" int tg_rowstats_norms(const void* M, float* m, float* l, float* u, float* s1,
                                 float* s2, int c, int s, int m_bf16, int load_bytes,
                                 void* stream) {
  return (int)launch_rowstats<true>(M, m, l, u, s1, s2, c, s, m_bf16, load_bytes,
                                    (cudaStream_t)stream);
}
