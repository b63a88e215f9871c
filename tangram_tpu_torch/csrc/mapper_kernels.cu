// Hand-written Hopper (sm_90a) kernels for the fused mapping step.
//
// The fused Tangram step streams the (cells x spots) logits M through a few
// passes and never stores the softmax P = softmax(M, rows) or its cotangent
// dP:
//
//   tg_rowstats         per-cell online softmax stats m, l, u       (init only)
//   tg_rowstats_norms   the same plus s1 = sum |M|, s2 = sum M^2    (init, L1/L2)
//   tg_project          Y = P^T A and q = w P                      (every step)
//                       (project_tc_kernels.cu)
//   tg_rbar             r_c = sum_s P * dP                         (every step)
//   tg_dm_adam          g = P (dP - r) [+ L1/L2 gradient], exact Adam in
//                       place on M/mu/nu, and the next step's m, l, u
//                       [, s1, s2]                                 (Adam steps)
//   tg_gsq              sum_s g^2 per cell and sum_c g^2 per spot  (Adafactor)
//   tg_dm_adafactor_tc  M -= lr g rowf[c] colf[s] in place, and the next
//                       step's m, l, u [, s1, s2]                  (Adafactor)
//   tg_dm_backward_tc   dM = P (dP - r) and [dA | dw] = P [dY | dq], the
//                       backward of the unfused core              (autograd)
//
// with dP = A dY^T + w (x) dq [+ dh (x) (log P + 1)] formed tile by tile.
// Each kernel replaces one Pallas TPU kernel of the JAX package (named at
// each kernel below). The TPU grid carries sums from one grid step to the
// next in VMEM; here a loop inside the block takes that place, and every
// cross-thread reduction has a fixed order, so all kernels are
// deterministic (no atomics).
//
// This file holds the row stats and gsq on the f32 FMA dP tile; tg_rbar,
// tg_dm_adam, tg_dm_adafactor_tc and tg_dm_backward_tc are in
// dp_tensor_kernels.cu, on the tensor-core dP tile, and tg_project in
// project_tc_kernels.cu, on the tensor cores too; common.cuh holds what
// they share.
//
// Precision: every product in this file is a plain f32 FMA on the CUDA
// cores, i.e. IEEE f32 by construction. One tensor-core TF32 pass would keep
// about three decimal digits, the class of fault that degraded the JAX
// package's held-out score on the TPU; the tensor-core kernels take three
// passes over split operands and keep f32 accuracy. The price here: gsq
// does about 2 * c * s * (k + 1) flops per call (1.3e11 at the 26,000 x
// 9,852 x 249 tutorial shape), which makes it bound by the FMA pipes and,
// before those, by shared-memory loads.
//
// All shared memory is static and below 48 KB per block. Every entry point
// launches on the given stream, does not synchronise, allocates nothing and
// returns cudaGetLastError() so the caller can raise on a refused launch.
//
// Low-precision storage (the JAX package's param_dtype and compute_dtype
// options): M may be stored in bf16, and A and dY may come rounded to bf16.
// Every load converts to f32 and all arithmetic stays f32, exactly as in
// the f32 kernels. M's type is a template parameter of rowstats (its loads
// differ in shape), and a uniform runtime flag of gsq (its loads sit in the
// epilogue, a few instructions per element beside its 2 (k + 1) flops).

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// rowstats — replaces tangram_tpu/ops/pallas_core.py::_rowstats;
// rowstats<NORMS> replaces tangram_tpu/ops/fused_step.py::_rowstats_norms
//
// One warp per cell row; lanes stride along spots (coalesced), each keeps an
// online (m, l, u) [and s1, s2] and the warp merges them by shuffle in a
// fixed order. Bound: one read of M (1.02 GB at the tutorial shape in f32,
// 0.51 GB in bf16); the exp per element is far below the SFU rate and the
// norms add two FMAs. TM is M's storage type, float or bf16.
// ---------------------------------------------------------------------------

constexpr int RS_THREADS = 256;

template <bool NORMS, typename TM>
__global__ void __launch_bounds__(RS_THREADS)
rowstats_kernel(const TM* __restrict__ M, float* __restrict__ m_out,
                float* __restrict__ l_out, float* __restrict__ u_out,
                float* __restrict__ s1_out, float* __restrict__ s2_out, int c, int s) {
  const int row = (blockIdx.x * RS_THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= c) return;  // the whole warp leaves together
  const TM* Mrow = M + (size_t)row * s;
  float m = NEG_BIG, l = 0.0f, u = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int j = lane; j < s; j += 32) {
    const float x = load_f32(Mrow + j);
    stats_push(m, l, u, x);
    if (NORMS) norms_push(s1, s2, x);
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

// ---------------------------------------------------------------------------
// gsq — replaces tangram_tpu/ops/fused_step.py::_gsq (_gsq_kernel), on the
// f32 FMA dP tile.
//
// Two dP tiles form dP = A dY^T + w (x) dq tile by tile: the tensor-core
// tile of dp_tensor_kernels.cu (rbar and the updates, dm_backward) and this
// one, which only gsq still takes: its per-spot sums cross the cell blocks
// and need a design of their own before they move to the tensor cores.
// Bound by shared-memory loads, then the FMA pipes (2.7 FMAs per
// shared-memory float from a 4 x 8 register tile).
//
// A block owns 64 whole cell rows and loops over all spots in tiles of 128.
// Per tile it forms dP = A_ext dY_ext^T (A_ext = [A | w], dY_ext = [dY | dq],
// both passed transposed so every staging copy is coalesced) by looping
// over k in chunks of 32 through a cp.async double buffer in shared memory
// (the next chunk, or the next tile's first chunk, is in flight while the
// current one computes); each thread holds a 4-cell x 8-spot register tile.
// The epilogue reads M for those elements, recomputes P from (m, l), adds
// dh (log P + 1) when WITH_DH, forms the gradient g = P (dP - r) +
// lam1 sign(M) + 2 lam2 M (grad_elem in common.cuh, the counterpart of
// _grad_tile, so the updates on the tensor-core tile see the same g) and
// accumulates g^2 per cell (vr) and per spot (vc).
// A block owns whole rows, so its per-cell sums need no merge across
// blocks: the 16 threads sharing a cell group reduce by shuffle in a fixed
// order. With few cells (clusters mode has tens) that would leave most of
// the card idle, so the spot tiles are also shared out over `nsplit` blocks
// per cell group (grid.y); each writes the row sums of its spot range and
// dp_merge adds them in split order. The per-spot sums cross the cell
// blocks: the 16 cell groups of a block add their column sums through
// shared memory in a fixed order, each cell block writes one row of a
// (ceil(c / 64), s) partial, and col_sum adds the rows in block order (the
// counterpart of the TPU kernel's column partials).
// Bound: f32 FMA, 2 c s (k+1) flops.
// ---------------------------------------------------------------------------

constexpr int DP_TC = 64;    // cells per block
constexpr int DP_TS = 128;   // spots per tile
constexpr int DP_KC = 32;    // k chunk
constexpr int DP_THREADS = 256;

// Everything the gsq kernel reads or writes.
struct GsqArgs {
  const void* M;          // (c, s) f32 or bf16
  const float* AT;        // (K1, c) = [A | w]^T
  const float* dYT;       // (K1, s) = [dY | dq]^T
  const float* dh;        // (c,)
  const float* m;         // (c,) row max
  const float* l;         // (c,) row sum of exp
  const float* r;         // (c,) softmax-VJP row term
  float* row_part;        // (nsplit, c) row sums vr
  float* col_part;        // (ceil(c / DP_TC), s) column sums per cell block
  int c, s, K1, vec, tiles_per_split;
  float lam1, two_lam2;   // L1 and 2 * L2 strength; both 0 without norms
  int m_bf16;             // M's storage is bf16 (else f32)
};

// entries at..at+3 of an f32 (bf16 == false) or bf16 array, as f32; entries
// from n_valid on read 0. vec: 16-byte (f32) or 8-byte (bf16) accesses.
__device__ __forceinline__ void load4(const void* base, size_t at, bool bf16_store,
                                      int n_valid, bool vec, float v[4]) {
  if (bf16_store) {
    const unsigned short* p = static_cast<const unsigned short*>(base) + at;
    if (vec && n_valid >= 4) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      v[0] = __uint_as_float(t.x << 16);
      v[1] = __uint_as_float(t.x & 0xFFFF0000u);
      v[2] = __uint_as_float(t.y << 16);
      v[3] = __uint_as_float(t.y & 0xFFFF0000u);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = q < n_valid ? bf16_bits_to_f32(p[q]) : 0.0f;
    }
    return;
  }
  const float* p = static_cast<const float*>(base) + at;
  if (vec && n_valid >= 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = q < n_valid ? p[q] : 0.0f;
  }
}


template <bool WITH_DH>
__global__ void __launch_bounds__(DP_THREADS, 2)
gsq_kernel(const GsqArgs a) {
  __shared__ __align__(16) float As[2][DP_KC][DP_TC];
  __shared__ __align__(16) float Ds[2][DP_KC][DP_TS];
  const float* __restrict__ AT = a.AT;
  const float* __restrict__ dYT = a.dYT;
  const int c = a.c, s = a.s, K1 = a.K1;
  const bool vec = a.vec != 0;
  const bool norm_grad = a.lam1 != 0.0f || a.two_lam2 != 0.0f;
  const bool m_bf16 = a.m_bf16 != 0;
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
      const float l = a.l[cell];
      cm[i] = a.m[cell];
      cinvl[i] = 1.0f / l;
      clogl[i] = logf(l);
      if (WITH_DH) cdh[i] = a.dh[cell];
      cr[i] = a.r[cell];
    }
  }

  float racc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // vr

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
  const int tile0 = blockIdx.y * a.tiles_per_split;
  const int n_tiles = max(0, min((s + DP_TS - 1) / DP_TS - tile0, a.tiles_per_split));
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
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // As[buf] and Ds[buf] are free for the next copies
    if (ki != n_k - 1) continue;

    float csum[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!cvalid[i]) continue;
      const size_t row = (size_t)(c0 + ty * 4 + i) * s;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int spot = s0 + half * 64 + tx * 4;
        const int n_valid = min(4, s - spot);
        if (n_valid <= 0) continue;
        float x[4];
        load4(a.M, row + spot, m_bf16, n_valid, vec, x);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= n_valid) continue;
          const float P = expf(x[q] - cm[i]) * cinvl[i];
          float dP = acc[i][half * 4 + q];
          if (WITH_DH) dP += cdh[i] * ((x[q] - cm[i] - clogl[i]) + 1.0f);
          const float g = grad_elem(P, dP, cr[i], x[q], a.lam1, a.two_lam2, norm_grad);
          const float g2 = g * g;
          racc[i] += g2;
          csum[half * 4 + q] += g2;
        }
      }
    }
    // column sums of g^2 over the block's 64 cells: each cell group puts
    // its 8 spot sums in row ty of the free buffer Ds[buf], then one
    // thread per spot adds the 16 rows in order
    float (*cs)[DP_TS] = Ds[buf];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      cs[ty][tx * 4 + q] = csum[q];
      cs[ty][64 + tx * 4 + q] = csum[4 + q];
    }
    __syncthreads();
    if (tid < DP_TS && s0 + tid < s) {
      float v = 0.0f;
#pragma unroll
      for (int t = 0; t < DP_THREADS / 16; ++t) v += cs[t][tid];
      a.col_part[(size_t)blockIdx.x * s + s0 + tid] = v;
    }
    __syncthreads();  // the next step's copies may overwrite Ds[buf]
  }

  // the 16 threads of a cell group are 16 aligned lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) racc[i] = sum_reduce(racc[i], 16);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (cvalid[i]) a.row_part[(size_t)blockIdx.y * c + (c0 + ty * 4 + i)] = racc[i];
  }
}


// vc[spot] = the sum of the (rows, s) gsq column partials, in row order
__global__ void col_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                               int rows, int s) {
  const int spot = blockIdx.x * blockDim.x + threadIdx.x;
  if (spot >= s) return;
  float acc = 0.0f;
  for (int r = 0; r < rows; ++r) acc += part[(size_t)r * s + spot];
  out[spot] = acc;
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes). Each returns the cudaError_t of its
// launches; 0 means the kernels were enqueued.
// ---------------------------------------------------------------------------

template <bool NORMS>
cudaError_t launch_rowstats(const void* M, float* m, float* l, float* u, float* s1,
                            float* s2, int c, int s, int m_bf16, cudaStream_t st) {
  const int warps_per_block = RS_THREADS / 32;
  const dim3 grid((c + warps_per_block - 1) / warps_per_block);
  if (m_bf16)
    rowstats_kernel<NORMS, bf16><<<grid, RS_THREADS, 0, st>>>(
        static_cast<const bf16*>(M), m, l, u, s1, s2, c, s);
  else
    rowstats_kernel<NORMS, float><<<grid, RS_THREADS, 0, st>>>(
        static_cast<const float*>(M), m, l, u, s1, s2, c, s);
  return cudaGetLastError();
}

extern "C" int tg_rowstats(const void* M, float* m, float* l, float* u, int c,
                           int s, int m_bf16, void* stream) {
  return (int)launch_rowstats<false>(M, m, l, u, nullptr, nullptr, c, s, m_bf16,
                                     (cudaStream_t)stream);
}

// as tg_rowstats, plus s1 = sum |M| and s2 = sum M^2 over M > PAD_GUARD
extern "C" int tg_rowstats_norms(const void* M, float* m, float* l, float* u,
                                 float* s1, float* s2, int c, int s, int m_bf16,
                                 void* stream) {
  return (int)launch_rowstats<true>(M, m, l, u, s1, s2, c, s, m_bf16,
                                    (cudaStream_t)stream);
}

// AT (k + 1, c) = [A | w]^T; dYT (k + 1, s) = [dY | dq]^T (f32, the A and dY
// rows rounded to bf16 by the caller under a bf16 compute type: a product
// of two bf16 is exact in f32, so the tile is JAX's bf16 x bf16 -> f32 dot up
// to summation order); dh, m, l, r: (c,); vec != 0 allows 16-byte (f32) or
// 8-byte (bf16) loads of 4 entries along spots of M (s % 4 == 0 and its base
// aligned so); nsplit: spot-axis splits (grid.y); lam1 and two_lam2: the L1
// strength and twice the L2 strength (0 and 0 without the norm terms);
// m_bf16: M's storage is bf16. vr_part: (nsplit, c) and vc_part:
// (ceil(c / 64), s) scratch; vr: (c,) = sum over spots of g^2; vc: (s,) =
// sum over cells of g^2.
extern "C" int tg_gsq(const void* M, const float* AT, const float* dYT,
                      const float* dh, const float* m, const float* l, const float* r,
                      float* vr_part, float* vc_part, float* vr, float* vc, int c,
                      int s, int K1, int with_dh, float lam1, float two_lam2, int vec,
                      int nsplit, int m_bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  GsqArgs a = {};
  a.M = M;
  a.AT = AT;
  a.dYT = dYT;
  a.dh = dh;
  a.m = m;
  a.l = l;
  a.r = r;
  a.row_part = vr_part;
  a.col_part = vc_part;
  a.c = c;
  a.s = s;
  a.K1 = K1;
  a.vec = vec;
  a.lam1 = lam1;
  a.two_lam2 = two_lam2;
  a.m_bf16 = m_bf16;
  const int n_tiles = (s + DP_TS - 1) / DP_TS;
  a.tiles_per_split = (n_tiles + nsplit - 1) / nsplit;
  const dim3 grid((c + DP_TC - 1) / DP_TC, nsplit);
  if (with_dh)
    gsq_kernel<true><<<grid, DP_THREADS, 0, st>>>(a);
  else
    gsq_kernel<false><<<grid, DP_THREADS, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dp_merge_kernel<false, false><<<(c + 255) / 256, 256, 0, st>>>(
      vr_part, vr, nullptr, nullptr, nullptr, nullptr, c, nsplit);
  col_sum_kernel<<<(s + 255) / 256, 256, 0, st>>>(vc_part, vc, (c + DP_TC - 1) / DP_TC, s);
  return (int)cudaGetLastError();
}
