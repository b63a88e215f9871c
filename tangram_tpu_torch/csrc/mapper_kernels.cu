// Hand-written Hopper (sm_90a) kernels for the fused mapping step.
//
// The fused Tangram step streams the (cells x spots) logits M through a few
// passes and never stores the softmax P = softmax(M, rows) or its cotangent
// dP:
//
//   tg_rowstats        per-cell online softmax stats m, l, u        (init only)
//   tg_rowstats_norms  the same plus s1 = sum |M|, s2 = sum M^2     (init, L1/L2)
//   tg_project         Y = P^T A and q = w P                       (every step)
//                      (project_tc_kernels.cu)
//   tg_rbar            r_c = sum_s P * dP                          (every step)
//   tg_dm_adam         g = P (dP - r) [+ L1/L2 gradient], exact Adam in
//                      place on M/mu/nu, and the next step's m, l, u
//                      [, s1, s2]                                  (Adam steps)
//   tg_gsq             sum_s g^2 per cell and sum_c g^2 per spot   (Adafactor)
//   tg_dm_adafactor    M -= lr g rowf[c] colf[s] in place, and the next
//                      step's m, l, u [, s1, s2]                   (Adafactor)
//   tg_dm_backward     dM = P (dP - r) and [dA | dw] = P [dY | dq], the
//                      backward of the unfused core               (autograd)
//
// with dP = A dY^T + w (x) dq [+ dh (x) (log P + 1)] formed tile by tile.
// Each kernel replaces one Pallas TPU kernel of the JAX package (named at
// each kernel below). The TPU grid carries sums from one grid step to the
// next in VMEM; here a loop inside the block takes that place, and every
// cross-thread reduction has a fixed order, so all kernels are
// deterministic (no atomics).
//
// This file holds the row stats and the f32 FMA dP tile (gsq, dm_adafactor,
// dm_backward); tg_rbar and tg_dm_adam are in dp_tensor_kernels.cu, on the
// tensor-core dP tile, and tg_project in project_tc_kernels.cu, on the
// tensor cores too; common.cuh holds what they share.
//
// Precision: every product in this file is a plain f32 FMA on the CUDA
// cores, i.e. IEEE f32 by construction. One tensor-core TF32 pass would keep
// about three decimal digits, the class of fault that degraded the JAX
// package's held-out score on the TPU; the tensor-core kernels take three
// passes over split operands and keep f32 accuracy. The price here: the
// three FMA dP-tile kernels each do about 2 * c * s * (k + 1) flops per call
// (1.3e11 at the 26,000 x 9,852 x 249 tutorial shape), which makes them
// bound by the FMA pipes and, before those, by shared-memory loads.
//
// All shared memory is static and below 48 KB per block, except the
// dm_backward tile's 64 KB of dynamic shared memory, for which the launch
// opts in with cudaFuncSetAttribute. Every entry point launches on the
// given stream, does not synchronise, allocates nothing and returns
// cudaGetLastError() so the caller can raise on a refused launch.
//
// Low-precision storage (the JAX package's param_dtype, moment_dtype and
// compute_dtype options, and rounding="stochastic"): M, and Adam's mu and
// nu, may be stored in bf16, and A and dY may come rounded to bf16. Every
// load converts to f32 and all arithmetic stays f32, exactly as in the f32
// kernels. The update kernels round what they store to nearest even (as
// jnp's astype) or stochastically (stored_value below), and fold the
// STORED value into the next step's stats, as _emit_next_stats does, so
// the next softmax normalizes the M it will read. M's type is a template
// parameter of rowstats (its loads differ in shape), and a
// uniform runtime flag of the dP-tile kernels beside the rounding (their
// loads sit in the epilogue, a few instructions per element beside its
// 2 (k + 1) flops). dm_backward takes f32 only.

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
// dP tiles. Two kernels form dP = A dY^T + w (x) dq tile by tile:
//
//   the tensor-core tile (dp_tensor_kernels.cu): rbar and dm_adam. A dY^T
//   as three TF32 products of split f32 operands (one exact product for
//   bf16 operands) by mma.sync, w (x) dq added in the epilogue; A resident
//   in shared memory, dY streamed, M/mu/nu staged by cp.async under the
//   product; one block of 512 threads per SM. Bound: rbar by the tensor
//   cores' 3xTF32 rate, dm_adam by its 6 GB of M, mu, nu. See that file.
//
//   the f32 FMA tile (below): one kernel, three epilogues. Bound by
//   shared-memory loads, then the FMA pipes (2.7 FMAs per shared-memory
//   float from a 4 x 8 register tile). gsq's column sums across cell blocks
//   and dm's second product over spots need designs of their own before
//   they move to the tensor-core tile.
//
//   EPI_GSQ        replaces tangram_tpu/ops/fused_step.py::_gsq (_gsq_kernel)
//   EPI_ADAFACTOR  replaces tangram_tpu/ops/fused_step.py::_dm_adafactor
//                  (_dm_adafactor_kernel), bf16 M and stochastic rounding
//                  included
//   EPI_DM         replaces tangram_tpu/ops/pallas_core.py::_backward's second
//                  call (_dm_kernel): the backward of the unfused core (f32)
//
// A block owns 64 whole cell rows and loops over all spots in tiles of 128.
// Per tile it forms dP = A_ext dY_ext^T (A_ext = [A | w], dY_ext = [dY | dq],
// both passed transposed so every staging copy is coalesced) by looping
// over k in chunks of 32 through a cp.async double buffer in shared memory
// (the next chunk, or the next tile's first chunk, is in flight while the
// current one computes); each thread holds a 4-cell x 8-spot register tile.
// The epilogue reads M (and mu, nu, or colf) for those elements, recomputes
// P from (m, l), adds dh (log P + 1) when WITH_DH, forms the gradient
// g = P (dP - r) + lam1 sign(M) + 2 lam2 M in one place (grad_elem in
// common.cuh, the counterpart of _grad_tile), so Adam (on the tensor-core
// tile), gsq and Adafactor see the same g, and
//   gsq:       accumulates g^2 per cell (vr) and per spot (vc, below);
//   adafactor: M -= lr g rowf[c] colf[s], stored in place;
//   dm:        stores dM = g (without L1/L2 terms) to its own array, and adds
//              P [dY | dq] over the tile to [dA | dw] (see the EPI_DM block);
// and the update folds the stored M into the next step's online
// (m, l, u) [and, with NORMS, its s1 = sum |M|, s2 = sum M^2].
// A block owns whole rows, so its per-cell sums need no merge across
// blocks: the 16 threads sharing a cell group reduce by shuffle in a fixed
// order. With few cells (clusters mode has tens) that would leave most of
// the card idle, so the spot tiles are also shared out over `nsplit` blocks
// per cell group (grid.y); each writes the row sums of its spot range and
// dp_merge adds them (vr, s1, s2) or merges them (m, l, u) in split
// order. gsq's per-spot sums cross the cell blocks: the 16 cell groups of a
// block add their column sums through shared memory in a fixed order, each
// cell block writes one row of a (ceil(c / 64), s) partial, and col_sum adds
// the rows in block order (the counterpart of the TPU kernel's column
// partials).
// Bound: f32 FMA (gsq and adafactor do 2 c s (k+1) flops each); adafactor
// also moves 1 read and 1 write of c x s. dm does twice the flops (its
// second product P [dY | dq]) and writes dM.
//
// dm's second product reduces over spots, the axis the block walks, into a
// (64 cells x (k + 1)) result that is far too large for registers (250
// columns here) and, beside the dP tile's buffers, for shared memory. So
// each tile's P goes to shared memory as a (spots x cells) tile, zero
// outside the valid cells and spots; the k + 1 columns are taken in chunks
// of 64 ([dY | dq] staged in shared memory beside it), each thread owns a
// 4-cell x 4-column register tile per chunk, and adds it into the block's
// own slice of a (nsplit, c, k + 1) partial in device memory: the first
// tile writes, later ones add (read-modify-write of addresses no other
// thread touches, mostly L2 hits). ext_reduce (common.cuh) then adds the
// splits in order. Deterministic, no atomics, like the rest.
// ---------------------------------------------------------------------------

constexpr int DP_TC = 64;    // cells per block
constexpr int DP_TS = 128;   // spots per tile
constexpr int DP_KC = 32;    // k chunk
constexpr int DP_THREADS = 256;
constexpr int DM_KC = 64;    // [dY | dq] columns per chunk of dm's second product
// dm's dynamic shared memory: the P tile (DP_TS x DP_TC) and a (DP_TS x
// DM_KC) chunk of [dY | dq]; with the 48 KB of static buffers, 112 KB, so two
// blocks fit on an SM
constexpr size_t DM_SMEM = (size_t)DP_TS * (DP_TC + DM_KC) * sizeof(float);

enum Epilogue : int { EPI_GSQ = 0, EPI_ADAFACTOR = 1, EPI_DM = 2 };

// Everything a dP-tile kernel reads or writes; a pointer an epilogue does
// not use may be null.
struct DpArgs {
  void* M;                // (c, s) f32 or bf16; updated in place by adafactor
  const float* AT;        // (K1, c) = [A | w]^T
  const float* dYT;       // (K1, s) = [dY | dq]^T
  const float* dh;        // (c,)
  const float* m;         // (c,) row max
  const float* l;         // (c,) row sum of exp
  const float* r;         // (c,) softmax-VJP row term
  const float* rowf;      // (c,) Adafactor row factor
  const float* colf;      // (s,) Adafactor column factor
  float* row_part;        // (nsplit, c) row sums vr (gsq)
  float* col_part;        // (ceil(c / DP_TC), s) gsq column sums per cell block
  float* st_part;         // (5, nsplit, c) next stats m, l, u, s1, s2 (updates)
  float* dM;              // (c, s) dm's gradient output
  const float* dYE;       // (s, K1) = [dY | dq], row-major (dm's second product)
  float* ext_part;        // (nsplit, c, K1) dm's [dA | dw] partials
  int c, s, K1, vec, tiles_per_split;
  float lr;               // adafactor
  float lam1, two_lam2;   // L1 and 2 * L2 strength; both 0 without norms
  int m_bf16;             // M's storage is bf16 (else f32)
  int sr;                 // the update rounds stochastically (else to nearest)
  unsigned t;             // the step count that seeds stochastic rounding
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

// the inverse of load4; a bf16 array takes the upper halves of v, which
// stored_value has made exact bf16 values
__device__ __forceinline__ void store4(void* base, size_t at, bool bf16_store, int n_valid,
                                       bool vec, const float v[4]) {
  if (bf16_store) {
    unsigned short* p = static_cast<unsigned short*>(base) + at;
    if (vec && n_valid >= 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(
          (__float_as_uint(v[0]) >> 16) | (__float_as_uint(v[1]) & 0xFFFF0000u),
          (__float_as_uint(v[2]) >> 16) | (__float_as_uint(v[3]) & 0xFFFF0000u));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < n_valid) p[q] = (unsigned short)(__float_as_uint(v[q]) >> 16);
    }
    return;
  }
  float* p = static_cast<float*>(base) + at;
  if (vec && n_valid >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < n_valid) p[q] = v[q];
  }
}


template <bool WITH_DH, int EPI, bool NORMS>
__global__ void __launch_bounds__(DP_THREADS, 2)
dp_kernel(const DpArgs a) {
  constexpr bool UPDATE = EPI == EPI_ADAFACTOR;
  constexpr bool ROW_SUM = EPI == EPI_GSQ;
  __shared__ __align__(16) float As[2][DP_KC][DP_TC];
  __shared__ __align__(16) float Ds[2][DP_KC][DP_TS];
  extern __shared__ __align__(16) float dyn[];  // EPI_DM only (DM_SMEM bytes)
  const float* __restrict__ AT = a.AT;
  const float* __restrict__ dYT = a.dYT;
  const int c = a.c, s = a.s, K1 = a.K1;
  const bool vec = a.vec != 0;
  const bool norm_grad = a.lam1 != 0.0f || a.two_lam2 != 0.0f;
  const bool m_bf16 = a.m_bf16 != 0, sr = a.sr != 0;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;   // 16 cell groups of 4 cells
  const int tx = tid & 15;   // 16 spot groups: tx*4.. and 64+tx*4..
  const int c0 = blockIdx.x * DP_TC;

  float cm[4], cinvl[4], clogl[4], cdh[4], cr[4], crf[4];
  bool cvalid[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int cell = c0 + ty * 4 + i;
    cvalid[i] = cell < c;
    cm[i] = cinvl[i] = clogl[i] = cdh[i] = cr[i] = crf[i] = 0.0f;
    if (cvalid[i]) {
      const float l = a.l[cell];
      cm[i] = a.m[cell];
      cinvl[i] = 1.0f / l;
      clogl[i] = logf(l);
      if (WITH_DH) cdh[i] = a.dh[cell];
      cr[i] = a.r[cell];
      if (EPI == EPI_ADAFACTOR) crf[i] = a.rowf[cell];
    }
  }

  float racc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // vr (gsq)
  float nm[4] = {NEG_BIG, NEG_BIG, NEG_BIG, NEG_BIG};
  float nl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float nu_[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float ns1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float ns2[4] = {0.0f, 0.0f, 0.0f, 0.0f};

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

    float csum[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // gsq
    float pt[4][8];  // dm: this thread's P values, 0 outside the valid region
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) pt[i][j] = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!cvalid[i]) continue;
      const int cell = c0 + ty * 4 + i;
      const size_t row = (size_t)cell * s;
      // stochastic-rounding key of this cell's M (salt 1)
      const uint32_t key_m = UPDATE && sr ? sr_key(a.t, (uint32_t)cell, 1u) : 0u;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int spot = s0 + half * 64 + tx * 4;
        const int n_valid = min(4, s - spot);
        if (n_valid <= 0) continue;
        float x[4], cf[4], dmv[4];
        load4(a.M, row + spot, m_bf16, n_valid, vec, x);
        if (EPI == EPI_ADAFACTOR) load4(a.colf, spot, false, n_valid, vec, cf);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (q >= n_valid) continue;
          const float P = expf(x[q] - cm[i]) * cinvl[i];
          float dP = acc[i][half * 4 + q];
          if (WITH_DH) dP += cdh[i] * ((x[q] - cm[i] - clogl[i]) + 1.0f);
          const float g = grad_elem(P, dP, cr[i], x[q], a.lam1, a.two_lam2, norm_grad);
          if constexpr (EPI == EPI_GSQ) {
            const float g2 = g * g;
            racc[i] += g2;
            csum[half * 4 + q] += g2;
          } else if constexpr (EPI == EPI_ADAFACTOR) {
            const float xn = x[q] - a.lr * ((g * crf[i]) * cf[q]);
            x[q] = stored_value(xn, m_bf16, sr, key_m, spot + q);
          } else {
            dmv[q] = g;
            pt[i][half * 4 + q] = P;
          }
          if (UPDATE) {  // the next stats see the stored value
            stats_push(nm[i], nl[i], nu_[i], x[q]);
            if (NORMS) norms_push(ns1[i], ns2[i], x[q]);
          }
        }
        if (UPDATE) store4(a.M, row + spot, m_bf16, n_valid, vec, x);
        if (EPI == EPI_DM) store4(a.dM, row + spot, false, n_valid, vec, dmv);
      }
    }
    if constexpr (EPI == EPI_DM) {
      // [dA | dw] += P [dY | dq] over this tile (see the comment above)
      float* Ps = dyn;                   // [DP_TS][DP_TC]
      float* Ys = dyn + DP_TS * DP_TC;   // [DP_TS][DM_KC]
#pragma unroll
      for (int hq = 0; hq < 8; ++hq) {
        const int ss = (hq >> 2) * 64 + tx * 4 + (hq & 3);
        *reinterpret_cast<float4*>(&Ps[ss * DP_TC + ty * 4]) =
            make_float4(pt[0][hq], pt[1][hq], pt[2][hq], pt[3][hq]);
      }
      const int kg = tid & 15;  // 16 groups of 4 columns
      const int cg = tid >> 4;  // 16 groups of 4 cells
      const bool first = step < n_k;  // the block's first spot tile
      for (int j0 = 0; j0 < K1; j0 += DM_KC) {
        for (int e = tid; e < DP_TS * DM_KC; e += DP_THREADS) {
          const int spot = s0 + e / DM_KC, j = j0 + e % DM_KC;
          Ys[e] = (spot < s && j < K1) ? a.dYE[(size_t)spot * K1 + j] : 0.0f;
        }
        __syncthreads();  // Ps and this chunk of Ys are visible to every thread
        float acc2[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc2[i][j] = 0.0f;
#pragma unroll 4
        for (int ss = 0; ss < DP_TS; ++ss) {
          const float4 p4 = *reinterpret_cast<const float4*>(&Ps[ss * DP_TC + cg * 4]);
          const float4 y4 = *reinterpret_cast<const float4*>(&Ys[ss * DM_KC + kg * 4]);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
          const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc2[i][j] = fmaf(pv[i], yv[j], acc2[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int cell = c0 + cg * 4 + i;
          if (cell >= c) continue;
          float* o = a.ext_part + ((size_t)blockIdx.y * c + cell) * K1;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = j0 + kg * 4 + j;
            if (col < K1) o[col] = first ? acc2[i][j] : o[col] + acc2[i][j];
          }
        }
        __syncthreads();  // Ys, and after the last chunk Ps, may be rewritten
      }
    }
    if constexpr (EPI == EPI_GSQ) {
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
  }

  if constexpr (EPI == EPI_DM) {
    // a split with no spot tiles still owns its slice of the partial
    if (n_tiles == 0)
      for (int e = tid; e < DP_TC * K1; e += DP_THREADS) {
        const int cell = c0 + e / K1;
        if (cell < c) a.ext_part[((size_t)blockIdx.y * c + cell) * K1 + e % K1] = 0.0f;
      }
  }

  // the 16 threads of a cell group are 16 aligned lanes of one warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (ROW_SUM) racc[i] = sum_reduce(racc[i], 16);
    if (UPDATE) {
      stats_reduce(nm[i], nl[i], nu_[i], 16);
      if (NORMS) {
        ns1[i] = sum_reduce(ns1[i], 16);
        ns2[i] = sum_reduce(ns2[i], 16);
      }
    }
  }
  if (tx == 0) {
    const size_t plane = (size_t)gridDim.y * c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (!cvalid[i]) continue;
      const size_t out = (size_t)blockIdx.y * c + (c0 + ty * 4 + i);
      if (ROW_SUM) a.row_part[out] = racc[i];
      if (UPDATE) {
        a.st_part[out] = nm[i];
        a.st_part[plane + out] = nl[i];
        a.st_part[2 * plane + out] = nu_[i];
        if (NORMS) {
          a.st_part[3 * plane + out] = ns1[i];
          a.st_part[4 * plane + out] = ns2[i];
        }
      }
    }
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

template <int EPI, bool NORMS>
cudaError_t launch_dp_kernel(bool with_dh, const DpArgs& a, dim3 grid, cudaStream_t st) {
  void (*kernel)(const DpArgs) =
      with_dh ? dp_kernel<true, EPI, NORMS> : dp_kernel<false, EPI, NORMS>;
  size_t smem = 0;
  if constexpr (EPI == EPI_DM) {
    smem = DM_SMEM;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {const_cast<DpArgs*>(&a)};
  const cudaError_t err = cudaLaunchKernel((const void*)kernel, grid, dim3(DP_THREADS),
                                           args, smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// launch the dP-tile kernel of epilogue EPI over (cell blocks, nsplit), then
// the merge of its per-cell partials into out0..out4
template <int EPI>
cudaError_t launch_dp(bool with_dh, bool norms, DpArgs a, int nsplit, float* out0,
                      float* out1, float* out2, float* out3, float* out4,
                      cudaStream_t st) {
  const int n_tiles = (a.s + DP_TS - 1) / DP_TS;
  a.tiles_per_split = (n_tiles + nsplit - 1) / nsplit;
  const dim3 grid((a.c + DP_TC - 1) / DP_TC, nsplit);
  const int merge_blocks = (a.c + 255) / 256;
  cudaError_t err;
  if constexpr (EPI == EPI_GSQ) {
    err = launch_dp_kernel<EPI, false>(with_dh, a, grid, st);
    if (err != cudaSuccess) return err;
    dp_merge_kernel<false, false><<<merge_blocks, 256, 0, st>>>(
        a.row_part, out0, nullptr, nullptr, nullptr, nullptr, a.c, nsplit);
  } else if constexpr (EPI == EPI_DM) {
    err = launch_dp_kernel<EPI, false>(with_dh, a, grid, st);
    if (err != cudaSuccess) return err;
    return launch_ext_reduce(a.ext_part, out0, out1, a.c, a.K1 - 1, nsplit, st);
  } else if (norms) {
    err = launch_dp_kernel<EPI, true>(with_dh, a, grid, st);
    if (err != cudaSuccess) return err;
    dp_merge_kernel<true, true><<<merge_blocks, 256, 0, st>>>(
        a.st_part, out0, out1, out2, out3, out4, a.c, nsplit);
  } else {
    err = launch_dp_kernel<EPI, false>(with_dh, a, grid, st);
    if (err != cudaSuccess) return err;
    dp_merge_kernel<true, false><<<merge_blocks, 256, 0, st>>>(
        a.st_part, out0, out1, out2, nullptr, nullptr, a.c, nsplit);
  }
  return cudaGetLastError();
}

DpArgs dp_args(const void* M, const float* AT, const float* dYT, const float* dh,
               const float* m, const float* l, int c, int s, int K1, int vec, int m_bf16) {
  DpArgs a = {};
  a.M = const_cast<void*>(M);
  a.m_bf16 = m_bf16;
  a.AT = AT;
  a.dYT = dYT;
  a.dh = dh;
  a.m = m;
  a.l = l;
  a.c = c;
  a.s = s;
  a.K1 = K1;
  a.vec = vec;
  return a;
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes). Each returns the cudaError_t of its
// launches; 0 means the kernels were enqueued.
//
// Shared arguments of the f32 FMA dP-tile entry points (tg_gsq,
// tg_dm_adafactor, tg_dm_backward; tg_rbar and tg_dm_adam, with operands in
// another layout, are in dp_tensor_kernels.cu): AT (k + 1, c) = [A | w]^T;
// dYT (k + 1, s) = [dY | dq]^T (f32, the A and dY rows rounded to bf16 by
// the caller under a bf16 compute type: a product of two bf16 is exact in
// f32, so the tile is JAX's bf16 x bf16 -> f32 dot up to summation order);
// dh, m, l, r: (c,); vec != 0 allows 16-byte (f32) or 8-byte (bf16)
// accesses of 4 entries along spots (s % 4 == 0 and every (c, s) / (s,)
// base aligned so); nsplit: spot-axis splits (see dp_kernel); lam1 and
// two_lam2: the L1 strength and twice the L2 strength (0 and 0 without the
// norm terms); m_bf16: M's storage is bf16; sr: the update stores by
// stochastic rounding seeded by step t (else round to nearest even).
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

// vr_part: (nsplit, c) and vc_part: (ceil(c / 64), s) scratch; vr: (c,) =
// sum over spots of g^2; vc: (s,) = sum over cells of g^2
extern "C" int tg_gsq(const void* M, const float* AT, const float* dYT,
                      const float* dh, const float* m, const float* l, const float* r,
                      float* vr_part, float* vc_part, float* vr, float* vc, int c,
                      int s, int K1, int with_dh, float lam1, float two_lam2, int vec,
                      int nsplit, int m_bf16, void* stream) {
  DpArgs a = dp_args(M, AT, dYT, dh, m, l, c, s, K1, vec, m_bf16);
  a.r = r;
  a.row_part = vr_part;
  a.col_part = vc_part;
  a.lam1 = lam1;
  a.two_lam2 = two_lam2;
  const cudaError_t err = launch_dp<EPI_GSQ>(with_dh != 0, false, a, nsplit, vr,
                                             nullptr, nullptr, nullptr, nullptr,
                                             (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  col_sum_kernel<<<(s + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      vc_part, vc, (c + DP_TC - 1) / DP_TC, s);
  return (int)cudaGetLastError();
}

// dYE: (s, k + 1) = [dY | dq], row-major; r: (c,) from tg_rbar with the same
// dh; dM: (c, s) = P (dP - r); ext_part: (nsplit, c, k + 1) scratch;
// dA: (c, k) = P dY; dw: (c,) = P dq
extern "C" int tg_dm_backward(const float* M, const float* AT, const float* dYT,
                              const float* dYE, const float* dh, const float* m,
                              const float* l, const float* r, float* dM, float* ext_part,
                              float* dA, float* dw, int c, int s, int K1, int with_dh,
                              int vec, int nsplit, void* stream) {
  DpArgs a = dp_args(M, AT, dYT, dh, m, l, c, s, K1, vec, 0);
  a.r = r;
  a.dM = dM;
  a.dYE = dYE;
  a.ext_part = ext_part;
  return (int)launch_dp<EPI_DM>(with_dh != 0, false, a, nsplit, dA, dw, nullptr, nullptr,
                                nullptr, (cudaStream_t)stream);
}

// M: (c, s), updated in place; rowf: (c,); colf: (s,); st_part and the stats
// outputs as for tg_dm_adam
extern "C" int tg_dm_adafactor(void* M, const float* AT, const float* dYT,
                               const float* dh, const float* m, const float* l,
                               const float* r, const float* rowf, const float* colf,
                               float* st_part, float* m_out, float* l_out,
                               float* u_out, float* s1_out, float* s2_out, int c,
                               int s, int K1, int with_dh, int with_norms, float lr,
                               float lam1, float two_lam2, int vec, int nsplit,
                               int m_bf16, int sr, int t, void* stream) {
  DpArgs a = dp_args(M, AT, dYT, dh, m, l, c, s, K1, vec, m_bf16);
  a.r = r;
  a.rowf = rowf;
  a.colf = colf;
  a.st_part = st_part;
  a.lr = lr;
  a.lam1 = lam1;
  a.two_lam2 = two_lam2;
  a.sr = sr;
  a.t = (unsigned)t;
  return (int)launch_dp<EPI_ADAFACTOR>(with_dh != 0, with_norms != 0, a, nsplit, m_out,
                                       l_out, u_out, s1_out, s2_out,
                                       (cudaStream_t)stream);
}
