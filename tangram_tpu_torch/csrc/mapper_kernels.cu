// Hand-written Hopper (sm_90a) kernels for the fused mapping step.
//
// The fused Tangram step streams the (cells x spots) logits M through four
// passes and never stores the softmax P = softmax(M, rows) or its cotangent
// dP:
//
//   tg_rowstats  per-cell online softmax stats m, l, u            (init only)
//   tg_project   Y = P^T A and q = w P                           (every step)
//   tg_rbar      r_c = sum_s P * dP                              (every step)
//   tg_dm_adam   g = P (dP - r), exact Adam in place on M/mu/nu,
//                and the next step's m, l, u                     (every step)
//
// with dP = A dY^T + w (x) dq [+ dh (x) (log P + 1)] formed tile by tile.
// Each kernel replaces one Pallas TPU kernel of the JAX package (named at
// each kernel below). The TPU grid carries sums from one grid step to the
// next in VMEM; here a loop inside the block takes that place, and every
// cross-thread reduction has a fixed order, so all four kernels are
// deterministic (no atomics).
//
// Precision: every product is a plain f32 FMA on the CUDA cores, i.e. IEEE
// f32 by construction. Tensor-core TF32 would keep about three decimal
// digits, the class of fault that degraded the JAX package's held-out score
// on the TPU. The price: project, rbar and dm_adam each do about
// 2 * c * s * (k + 1) flops per step (1.3e11 at the 26,000 x 9,852 x 249
// tutorial shape), which makes them compute-bound on the H100's f32 CUDA
// cores, not memory-bound. Faster variants (3xTF32 or bf16-split tensor-core
// products via wgmma, TMA loads, one shared dP recompute for rbar and
// dm_adam) are later work.
//
// All shared memory is static and below 48 KB per block, so no
// cudaFuncSetAttribute opt-in is needed. Every entry point launches on the
// given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr float NEG_BIG = -1e30f;
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

// ---------------------------------------------------------------------------
// rowstats — replaces tangram_tpu/ops/pallas_core.py::_rowstats
//
// One warp per cell row; lanes stride along spots (coalesced), each keeps an
// online (m, l, u) and the warp merges them by shuffle. Bound: one read of
// M (1.02 GB at the tutorial shape); the exp per element is far below the
// SFU rate.
// ---------------------------------------------------------------------------

constexpr int RS_THREADS = 256;

__global__ void __launch_bounds__(RS_THREADS)
rowstats_kernel(const float* __restrict__ M, float* __restrict__ m_out,
                float* __restrict__ l_out, float* __restrict__ u_out, int c, int s) {
  const int row = (blockIdx.x * RS_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= c) return;  // the whole warp leaves together
  const float* Mrow = M + (size_t)row * s;
  float m = NEG_BIG, l = 0.0f, u = 0.0f;
  for (int j = lane; j < s; j += 32) stats_push(m, l, u, __ldg(Mrow + j));
  stats_reduce(m, l, u, 32);
  if (lane == 0) {
    m_out[row] = m;
    l_out[row] = l;
    u_out[row] = u;
  }
}

// ---------------------------------------------------------------------------
// project — replaces tangram_tpu/ops/pallas_core.py::_project
//
// Y = P^T A and q = w P reduce over cells, the axis that crosses the softmax
// rows. w rides along as column k of A_ext = [A | w], so one contraction
// gives both (column k of the result is q). A block owns 64 spots x 256
// columns of A_ext and loops over its share of the cells in chunks of 16.
// The raw M chunk and the A_ext chunk arrive by cp.async into a double
// buffer, so the next chunk's loads (M from HBM, A from L2) are in flight
// while the current chunk computes; P is recomputed from (m, l) into shared
// memory, and each thread accumulates an 8 x 8 register tile.
// The cells are split into `nsplit` contiguous ranges (grid.z) to fill the
// card; each range writes its own partial sums, and project_reduce adds them
// in a fixed order. Bound: f32 FMA (2 c s (k+1) flops); M is read once,
// A_ext (26 MB) once per spot tile, mostly from L2.
// ---------------------------------------------------------------------------

constexpr int PJ_BS = 64;    // spots per block
constexpr int PJ_BJ = 256;   // A_ext columns per block
constexpr int PJ_BC = 16;    // cells per chunk
constexpr int PJ_THREADS = 256;

// 4-byte asynchronous copy global -> shared; valid == false writes zeros
__device__ __forceinline__ void cp_async_f32(float* smem, const float* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(PJ_THREADS, 2)
project_kernel(const float* __restrict__ M, const float* __restrict__ A,
               const float* __restrict__ w, const float* __restrict__ mrow,
               const float* __restrict__ lrow, float* __restrict__ partial,
               int c, int s, int k, int cells_per_split) {
  __shared__ __align__(16) float Ms[2][PJ_BC][PJ_BS];
  __shared__ __align__(16) float As[2][PJ_BC][PJ_BJ];
  __shared__ __align__(16) float Ps[PJ_BC][PJ_BS];
  const int tid = threadIdx.x;
  const int ty = tid >> 5;   // 8 spot groups of 8 spots
  const int tx = tid & 31;   // 32 column groups: tx*4.. and 128+tx*4..
  const int s0 = blockIdx.x * PJ_BS;
  const int j0 = blockIdx.y * PJ_BJ;
  const int K1 = k + 1;
  const int c_begin = blockIdx.z * cells_per_split;
  const int c_end = min(c, c_begin + cells_per_split);

  // start the copies of the chunk at cell c0 into buffer b
  auto issue = [&](int c0, int b) {
    for (int e = tid; e < PJ_BC * PJ_BS; e += PJ_THREADS) {
      const int cc = e / PJ_BS, ss = e % PJ_BS;
      const int cell = c0 + cc, spot = s0 + ss;
      const bool ok = cell < c_end && spot < s;
      cp_async_f32(&Ms[b][cc][ss], ok ? M + (size_t)cell * s + spot : M, ok);
    }
    for (int e = tid; e < PJ_BC * PJ_BJ; e += PJ_THREADS) {
      const int cc = e / PJ_BJ, jj = e % PJ_BJ;
      const int cell = c0 + cc, j = j0 + jj;
      const bool in = cell < c_end;
      const float* src = (in && j < k) ? A + (size_t)cell * k + j
                         : (in && j == k) ? w + cell : A;
      cp_async_f32(&As[b][cc][jj], src, in && j <= k);
    }
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if (c_begin < c_end) issue(c_begin, 0);
  int buf = 0;
  for (int c0 = c_begin; c0 < c_end; c0 += PJ_BC, buf ^= 1) {
    if (c0 + PJ_BC < c_end) {
      issue(c0 + PJ_BC, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's copies are visible to every thread
    for (int e = tid; e < PJ_BC * PJ_BS; e += PJ_THREADS) {
      const int cc = e / PJ_BS, ss = e % PJ_BS;
      const int cell = c0 + cc, spot = s0 + ss;
      float p = 0.0f;
      if (cell < c_end && spot < s)
        p = expf(Ms[buf][cc][ss] - mrow[cell]) * (1.0f / lrow[cell]);
      Ps[cc][ss] = p;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < PJ_BC; ++cc) {
      const float4 p0 = *reinterpret_cast<const float4*>(&Ps[cc][ty * 8]);
      const float4 p1 = *reinterpret_cast<const float4*>(&Ps[cc][ty * 8 + 4]);
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][cc][tx * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][cc][128 + tx * 4]);
      const float p[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p[i], a[j], acc[i][j]);
    }
    __syncthreads();  // Ps and As[buf] are free for the next chunk's writes
  }

  float* out = partial + (size_t)blockIdx.z * s * K1;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int spot = s0 + ty * 8 + i;
    if (spot >= s) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + (j < 4 ? tx * 4 + j : 128 + tx * 4 + (j - 4));
      if (col < K1) out[(size_t)spot * K1 + col] = acc[i][j];
    }
  }
}

// Y[spot, :k] and q[spot] = sum over the splits, in split order.
__global__ void project_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ Y, float* __restrict__ q,
                                      int s, int k, int nsplit) {
  const int K1 = k + 1;
  const size_t n = (size_t)s * K1;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.0f;
    for (int z = 0; z < nsplit; ++z) acc += partial[(size_t)z * n + e];
    const size_t spot = e / K1;
    const int col = (int)(e % K1);
    if (col < k) Y[spot * k + col] = acc;
    else q[spot] = acc;
  }
}

// ---------------------------------------------------------------------------
// dP tiles — rbar replaces tangram_tpu/ops/fused_step.py::_rbar (kernel
// pallas_core._rbar_kernel / _dp_tile); dm_adam replaces
// tangram_tpu/ops/fused_step.py::_dm_adam (_dm_adam_kernel, _grad_tile,
// _emit_next_stats) on its f32, no-L1/L2, round-to-nearest path.
//
// A block owns 64 whole cell rows and loops over all spots in tiles of 128.
// Per tile it forms dP = A_ext dY_ext^T (A_ext = [A | w], dY_ext = [dY | dq],
// both passed transposed so every staging copy is coalesced) by looping
// over k in chunks of 32 through a cp.async double buffer in shared memory
// (the next chunk, or the next tile's first chunk, is in flight while the
// current one computes); each thread holds a 4-cell x 8-spot register tile.
// The epilogue reads M (and mu, nu) for those
// elements, recomputes P from (m, l), adds dh (log P + 1) when WITH_DH, and
//   rbar:    accumulates r_c += P dP per cell;
//   dm_adam: g = P (dP - r), the exact Adam update (eps after the sqrt),
//            stores M, mu, nu in place, and folds the stored M into the
//            next step's online (m, l, u).
// A block owns whole rows, so its per-cell sums need no merge across
// blocks: the 16 threads sharing a cell group reduce by shuffle in a fixed
// order. With few cells (clusters mode has tens) that would leave most of
// the card idle, so the spot tiles are also shared out over `nsplit` blocks
// per cell group (grid.y); each writes the row sums of its spot range and
// dp_merge adds them (r) or merges them (m, l, u) in split order.
// Bound: f32 FMA, like project; dm_adam also moves 3 reads and 3 writes of
// c x s f32 (6 GB per step at the tutorial shape).
// ---------------------------------------------------------------------------

constexpr int DP_TC = 64;    // cells per block
constexpr int DP_TS = 128;   // spots per tile
constexpr int DP_KC = 32;    // k chunk
constexpr int DP_THREADS = 256;

__device__ __forceinline__ void load4(const float* p, int n_valid, bool vec, float v[4]) {
  if (vec && n_valid >= 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = q < n_valid ? p[q] : 0.0f;
  }
}

__device__ __forceinline__ void store4(float* p, int n_valid, bool vec, const float v[4]) {
  if (vec && n_valid >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < n_valid) p[q] = v[q];
  }
}

template <bool WITH_DH, bool ADAM>
__global__ void __launch_bounds__(DP_THREADS, 2)
dp_kernel(float* __restrict__ M, const float* __restrict__ AT,
          const float* __restrict__ dYT, const float* __restrict__ dh,
          const float* __restrict__ mrow, const float* __restrict__ lrow,
          const float* __restrict__ rrow, float* __restrict__ r_out,
          float* __restrict__ mu, float* __restrict__ nu,
          float* __restrict__ m_out, float* __restrict__ l_out,
          float* __restrict__ u_out, int c, int s, int K1,
          float lr, float bc1, float bc2, int vec, int tiles_per_split) {
  __shared__ __align__(16) float As[2][DP_KC][DP_TC];
  __shared__ __align__(16) float Ds[2][DP_KC][DP_TS];
  const int tid = threadIdx.x;
  const int ty = tid >> 4;   // 16 cell groups of 4 cells
  const int tx = tid & 15;   // 16 spot groups: tx*4.. and 64+tx*4..
  const int c0 = blockIdx.x * DP_TC;

  float cm[4], cinvl[4], clogl[4], cdh[4], cr[4];
  bool cvalid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int cell = c0 + ty * 4 + i;
    cvalid[i] = cell < c;
    cm[i] = cinvl[i] = clogl[i] = cdh[i] = cr[i] = 0.0f;
    if (cvalid[i]) {
      const float l = lrow[cell];
      cm[i] = mrow[cell];
      cinvl[i] = 1.0f / l;
      clogl[i] = logf(l);
      if (WITH_DH) cdh[i] = dh[cell];
      if (ADAM) cr[i] = rrow[cell];
    }
  }
  const float inv_bc1 = 1.0f / bc1;
  const float inv_bc2 = 1.0f / bc2;

  float racc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float nm[4] = {NEG_BIG, NEG_BIG, NEG_BIG, NEG_BIG};
  float nl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float nu_[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  // start the copies of k chunk k0 of spot tile s0 into buffer b
  auto issue = [&](int s0, int k0, int b) {
    for (int e = tid; e < DP_KC * DP_TC; e += DP_THREADS) {
      const int kk = e / DP_TC, cc = e % DP_TC;
      const int j = k0 + kk, cell = c0 + cc;
      const bool ok = j < K1 && cell < c;
      cp_async_f32(&As[b][kk][cc], ok ? AT + (size_t)j * c + cell : AT, ok);
    }
    for (int e = tid; e < DP_KC * DP_TS; e += DP_THREADS) {
      const int kk = e / DP_TS, ss = e % DP_TS;
      const int j = k0 + kk, spot = s0 + ss;
      const bool ok = j < K1 && spot < s;
      cp_async_f32(&Ds[b][kk][ss], ok ? dYT + (size_t)j * s + spot : dYT, ok);
    }
    cp_async_commit();
  };

  // one flat sequence of (spot tile, k chunk) steps over this block's spot
  // tiles, so the prefetch also runs across tile boundaries and overlaps
  // each tile's epilogue
  const int n_k = (K1 + DP_KC - 1) / DP_KC;
  const int tile0 = blockIdx.y * tiles_per_split;
  const int n_tiles = max(0, min((s + DP_TS - 1) / DP_TS - tile0, tiles_per_split));
  const int n_steps = n_tiles * n_k;
  float acc[4][8];
  if (n_steps > 0) issue(tile0 * DP_TS, 0, 0);
  int buf = 0;
  for (int step = 0; step < n_steps; ++step, buf ^= 1) {
    const int s0 = (tile0 + step / n_k) * DP_TS;
    const int ki = step % n_k;
    if (ki == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    if (step + 1 < n_steps) {
      issue((tile0 + (step + 1) / n_k) * DP_TS, (step + 1) % n_k * DP_KC, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk's copies are visible to every thread
#pragma unroll 8
    for (int kk = 0; kk < DP_KC; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[buf][kk][ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ds[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Ds[buf][kk][64 + tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // As[buf] and Ds[buf] are free for the next copies
    if (ki != n_k - 1) continue;

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!cvalid[i]) continue;
      const size_t row = (size_t)(c0 + ty * 4 + i) * s;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int spot = s0 + half * 64 + tx * 4;
        const int n_valid = min(4, s - spot);
        if (n_valid <= 0) continue;
        float x[4], mv[4], vv[4];
        load4(M + row + spot, n_valid, vec, x);
        if (ADAM) {
          load4(mu + row + spot, n_valid, vec, mv);
          load4(nu + row + spot, n_valid, vec, vv);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= n_valid) continue;
          const float P = expf(x[q] - cm[i]) * cinvl[i];
          float dP = acc[i][half * 4 + q];
          if (WITH_DH) dP += cdh[i] * ((x[q] - cm[i] - clogl[i]) + 1.0f);
          if (!ADAM) {
            racc[i] = fmaf(P, dP, racc[i]);
          } else {
            const float g = P * (dP - cr[i]);
            const float mun = BETA1 * mv[q] + ONE_MINUS_BETA1 * g;
            const float nun = BETA2 * vv[q] + ONE_MINUS_BETA2 * (g * g);
            const float m_hat = mun * inv_bc1;
            const float v_hat = nun * inv_bc2;
            const float xn = x[q] - lr * m_hat / (sqrtf(v_hat) + ADAM_EPS);
            x[q] = xn;
            mv[q] = mun;
            vv[q] = nun;
            stats_push(nm[i], nl[i], nu_[i], xn);
          }
        }
        if (ADAM) {
          store4(M + row + spot, n_valid, vec, x);
          store4(mu + row + spot, n_valid, vec, mv);
          store4(nu + row + spot, n_valid, vec, vv);
        }
      }
    }
  }

  // the 16 threads of a cell group are 16 aligned lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!ADAM) {
      for (int off = 8; off > 0; off >>= 1)
        racc[i] += __shfl_xor_sync(0xffffffffu, racc[i], off);
    } else {
      stats_reduce(nm[i], nl[i], nu_[i], 16);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!cvalid[i]) continue;
      const size_t out = (size_t)blockIdx.y * c + (c0 + ty * 4 + i);
      if (!ADAM) {
        r_out[out] = racc[i];
      } else {
        m_out[out] = nm[i];
        l_out[out] = nl[i];
        u_out[out] = nu_[i];
      }
    }
  }
}

// r = the sum of the split partials (rbar), or (m, l, u) = their online-stats
// merge (dm_adam), in split order: (nsplit, c) partials -> (c,) outputs
template <bool ADAM>
__global__ void dp_merge_kernel(const float* __restrict__ r_part, float* __restrict__ r,
                                const float* __restrict__ m_part,
                                const float* __restrict__ l_part,
                                const float* __restrict__ u_part, float* __restrict__ m,
                                float* __restrict__ l, float* __restrict__ u, int c,
                                int nsplit) {
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;
  if (cell >= c) return;
  if (!ADAM) {
    float acc = 0.0f;
    for (int z = 0; z < nsplit; ++z) acc += r_part[(size_t)z * c + cell];
    r[cell] = acc;
  } else {
    float mm = NEG_BIG, ll = 0.0f, uu = 0.0f;
    for (int z = 0; z < nsplit; ++z) {
      const size_t e = (size_t)z * c + cell;
      stats_merge(mm, ll, uu, m_part[e], l_part[e], u_part[e]);
    }
    m[cell] = mm;
    l[cell] = ll;
    u[cell] = uu;
  }
}

template <bool ADAM>
cudaError_t launch_dp(bool with_dh, float* M, const float* AT, const float* dYT,
                      const float* dh, const float* m, const float* l, const float* r,
                      float* r_part, float* mu, float* nu, float* m_part,
                      float* l_part, float* u_part, int c, int s, int K1, float lr,
                      float bc1, float bc2, int vec, int nsplit, cudaStream_t stream) {
  const int n_tiles = (s + DP_TS - 1) / DP_TS;
  const int tiles_per_split = (n_tiles + nsplit - 1) / nsplit;
  const dim3 grid((c + DP_TC - 1) / DP_TC, nsplit);
  if (with_dh)
    dp_kernel<true, ADAM><<<grid, DP_THREADS, 0, stream>>>(
        M, AT, dYT, dh, m, l, r, r_part, mu, nu, m_part, l_part, u_part, c, s, K1,
        lr, bc1, bc2, vec, tiles_per_split);
  else
    dp_kernel<false, ADAM><<<grid, DP_THREADS, 0, stream>>>(
        M, AT, dYT, dh, m, l, r, r_part, mu, nu, m_part, l_part, u_part, c, s, K1,
        lr, bc1, bc2, vec, tiles_per_split);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes). Each returns the cudaError_t of its
// launch; 0 means the kernel was enqueued.
// ---------------------------------------------------------------------------

extern "C" int tg_rowstats(const float* M, float* m, float* l, float* u, int c,
                           int s, void* stream) {
  const int warps_per_block = RS_THREADS / 32;
  const dim3 grid((c + warps_per_block - 1) / warps_per_block);
  rowstats_kernel<<<grid, RS_THREADS, 0, (cudaStream_t)stream>>>(M, m, l, u, c, s);
  return (int)cudaGetLastError();
}

// partial: (nsplit, s, k + 1) scratch; Y: (s, k); q: (s,)
extern "C" int tg_project(const float* M, const float* A, const float* w,
                          const float* m, const float* l, float* partial,
                          float* Y, float* q, int c, int s, int k, int nsplit,
                          void* stream) {
  const int K1 = k + 1;
  int cells_per_split = (c + nsplit - 1) / nsplit;
  cells_per_split = (cells_per_split + PJ_BC - 1) / PJ_BC * PJ_BC;
  const dim3 grid((s + PJ_BS - 1) / PJ_BS, (K1 + PJ_BJ - 1) / PJ_BJ, nsplit);
  project_kernel<<<grid, PJ_THREADS, 0, (cudaStream_t)stream>>>(
      M, A, w, m, l, partial, c, s, k, cells_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)s * K1;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  project_reduce_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(partial, Y, q, s,
                                                                   k, nsplit);
  return (int)cudaGetLastError();
}

// AT: (k + 1, c) = [A | w]^T; dYT: (k + 1, s) = [dY | dq]^T; r: (c,);
// r_part: (nsplit, c) scratch. vec != 0 allows 16-byte loads of M
// (s % 4 == 0, aligned base). nsplit: spot-axis splits (see dp_kernel).
extern "C" int tg_rbar(const float* M, const float* AT, const float* dYT,
                       const float* dh, const float* m, const float* l,
                       float* r_part, float* r, int c, int s, int K1, int with_dh,
                       int vec, int nsplit, void* stream) {
  const cudaError_t err = launch_dp<false>(
      with_dh != 0, const_cast<float*>(M), AT, dYT, dh, m, l, nullptr, r_part,
      nullptr, nullptr, nullptr, nullptr, nullptr, c, s, K1, 0.0f, 1.0f, 1.0f, vec,
      nsplit, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  dp_merge_kernel<false><<<(c + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      r_part, r, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, c, nsplit);
  return (int)cudaGetLastError();
}

// M, mu, nu: (c, s), updated in place; m_out, l_out, u_out: (c,) stats of the
// stored M; m_part, l_part, u_part: (nsplit, c) scratch. vec (for M, mu and
// nu) and nsplit as for tg_rbar.
extern "C" int tg_dm_adam(float* M, const float* AT, const float* dYT,
                          const float* dh, const float* m, const float* l,
                          const float* r, float* mu, float* nu, float* m_part,
                          float* l_part, float* u_part, float* m_out, float* l_out,
                          float* u_out, int c, int s, int K1, int with_dh, float lr,
                          float bc1, float bc2, int vec, int nsplit, void* stream) {
  const cudaError_t err = launch_dp<true>(
      with_dh != 0, M, AT, dYT, dh, m, l, r, nullptr, mu, nu, m_part, l_part,
      u_part, c, s, K1, lr, bc1, bc2, vec, nsplit, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  dp_merge_kernel<true><<<(c + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      nullptr, nullptr, m_part, l_part, u_part, m_out, l_out, u_out, c, nsplit);
  return (int)cudaGetLastError();
}
