// The tensor-core dP tile (sm_90a): rbar, the fused Adam and Adafactor
// updates, Adafactor's grad^2 statistics, and the backward of the unfused
// core.
//
//   tg_rbar             replaces tangram_tpu/ops/fused_step.py::_rbar (kernel
//                       pallas_core._rbar_kernel / _dp_tile), also as the
//                       first pass of pallas_core._backward; since
//                       dp_wgmma_kernels.cu takes rbar at K <= 256, only
//                       deeper K comes here (the island term's one-hot
//                       types past 256 genes: cuda_core.dp_route)
//   tg_gsq_tc           replaces tangram_tpu/ops/fused_step.py::_gsq
//                       (_gsq_kernel): sum_spots g^2 per cell and sum_cells
//                       g^2 per spot, L1/L2 terms and a bf16 M included
//   tg_dm_adam          replaces tangram_tpu/ops/fused_step.py::_dm_adam
//                       (_dm_adam_kernel, _grad_tile, _emit_next_stats,
//                       _sr_cast), L1/L2 terms, bf16 M/mu/nu and stochastic
//                       rounding included
//   tg_dm_adafactor_tc  replaces tangram_tpu/ops/fused_step.py::_dm_adafactor
//                       (_dm_adafactor_kernel): M -= lr g rowf[c] colf[s] in
//                       place and the next stats, bf16 M and stochastic
//                       rounding included
//   tg_dm_backward_tc   replaces the second call of
//                       tangram_tpu/ops/pallas_core.py::_backward (_dm_kernel):
//                       dM = P (dP - r) in M's type (f32 or bf16) and
//                       [dA | dw] = P [dY | dq]
//
// All form dP = A dY^T + w (x) dq [+ dh (x) (log P + 1)] tile by tile and
// never store it. Every launch of gsq, dm_adam, dm_adafactor and
// dm_backward comes here, at any K (a dm_adam on the warpgroup-MMA loop of
// dp_wgmma_kernels.cu measured slower than this tile's: see that file).
//
// What bounds them on the H100. The product is 2 c s k flops (1.28e11 at
// 26,000 x 9,852 x 249). On the f32 FMA pipes that is 1.9 ms at best, and a
// register-tiled FMA loop is held by its shared-memory loads long before. The
// tensor cores take TF32 operands (10 mantissa bits), which alone would
// lose the f32 accuracy the mapping needs; three TF32 products of split
// operands give it back (below) and cost 0.78 ms at the card's TF32 peak.
// rbar and gsq then read M once (1.02 GB, 0.31 ms): operations bound them.
// dm_adam reads and writes M, mu and nu (6.15 GB, 1.84 ms): bytes bound it.
// dm_adafactor reads and writes M (2.05 GB, 0.61 ms): operations bound it.
// dm_backward does two such products (1.55 ms) and reads M, writes dM.
//
// The design.
//  * f32 accuracy on the tensor cores (3xTF32). Each f32 operand x is split
//    in registers after the shared-memory load into hi = tf32(x) and
//    lo = x - hi (split_tf32 in common.cuh), and the tile sums
//    lo*hi + hi*lo + hi*hi with f32 accumulation, the small terms first, as
//    CUTLASS's OpMultiplyAddFastF32 does. The dropped lo*lo term is 2^-22 of
//    the product. The tensor cores truncate their running sum where an f32
//    FMA rounds it; accumulating all of K in one register biased the result
//    to 3-6 times the error of an f32 product (measured against float64).
//    So every 16 of K are summed into a fresh accumulator (6 mma, the first
//    onto zero) and added to the tile's sum by a rounded f32 add: the
//    truncations act on the small partial sums, whose signs vary.
//    The instruction is mma.sync.m16n8k8 (tf32 x tf32 -> f32): operands come
//    from registers, so the split needs no second copy of either operand in
//    shared memory or L2; wgmma reads B (and here both) from shared memory
//    and would need the split laid out there, doubling the resident A and
//    the streamed dY, which the staging below leaves no room for.
//    With a bf16 compute type (SPLIT = false) A and dY hold bf16 values,
//    which are exact in TF32, and a bf16 x bf16 product is exact in f32: one
//    pass computes JAX's bf16 dot up to summation order.
//    The rank-one term w (x) dq is not part of the product at all: the
//    epilogue adds w_c dq_s with one f32 FMA per entry, exactly.
//  * A resident, dY streamed. A block owns 64 cells. Its A panel (64 x up to
//    256 of K, f32, rows padded by 4 words so fragment loads hit 32 banks)
//    is copied to shared memory once and stays for all the block's spot
//    tiles; dY streams through a ring of 3 stages of 128 spots x 32 of K (a
//    full 128-byte line per row), filled by 16-byte cp.async two stages
//    ahead, also across tile boundaries, so a tile's epilogue runs with the
//    next tile's first chunks already in flight. The wrapper lays both
//    operands out K-major with K padded by zeros to a multiple of 32.
//    Deeper K (k > 256) walks panels of 256: the A panel is then reloaded
//    per (tile, panel), the accumulators stay in registers.
//    L2 traffic per launch: every block streams its tiles' dY rows whole
//    and copies its A rows once: 407 cell groups x 10.1 MB = 4.1 GB at the
//    tutorial shape.
//  * M, mu, nu under the product. When a tile's k loop starts, the tile's
//    M (and mu, nu) go by cp.async into a staging tile in shared memory (64
//    x 128 entries each in their storage type, rows padded by 8 entries), so
//    their HBM reads run while the tensor cores work and the epilogue reads
//    shared memory only; its stores leave from registers and drain under
//    the next tile's product. The copies take 16, 8 or 4 bytes at a time,
//    whichever the rows' alignment allows (a bf16 row of 9,852 entries is
//    19,704 bytes, not a multiple of 16: TMA could not take it); a bf16
//    array with an odd row length is copied element by element through
//    registers. The wrapper picks by shape and alignment, and the small
//    shapes of the checks run the narrow paths.
//    One block of 512 threads per SM: A 65 KB + ring 54 KB + staging 102 KB
//    (f32 M, mu, nu) + 1.75 KB of row constants = 222.75 KB of the 227 KB a
//    block may have (Adafactor stages M only: 154 KB; dm_backward M and the
//    P tile: 188 KB), <= 128 registers a thread. (Two blocks of 256 threads
//    per SM without staging, the first design, left the epilogue's loads
//    exposed: dm_adam took 11.5 ms, an L2 prefetch changed nothing.)
//  * 16 warps as 2 (cells) x 8 (spots), 32 x 16 per warp: 2 x 2 mma tiles,
//    16 accumulators a thread. The epilogue works in the accumulator
//    fragment's own layout (rows g and g + 8, two adjacent columns per
//    thread): 8-byte stores of f32 (4-byte of bf16), four lanes per 32-byte
//    sector, when s is even and the bases are aligned (vec); otherwise
//    element by element. Per-cell sums and the next online stats are kept
//    per thread across tiles, reduced over the quad's lanes by shuffle, then
//    over the 8 spot warps through shared memory in warp order, then over
//    the spot splits by dp_merge in split order: no atomics, bit-identical
//    repeats.
//  * Few cells (clusters mode) spread over the card by spot splits
//    (grid.y), chosen by the wrapper to fill whole waves of one block per SM.
//
// gsq's per-spot sums cross the cell blocks, so they take a design of their
// own, in a fixed order and without atomics. In the tile's epilogue each
// thread adds g^2 of its rows (g, g + 8 of both m-tiles) per column it
// holds, a butterfly over lane offsets 4, 8 and 16 adds the warp's 32 cells,
// and lanes 0-3 then hold the warp's 16 column sums. They go straight from
// registers into row (2 blockIdx.x + cell half) of a (2 ceil(c / 64), s)
// f32 partial: no barrier, no shared memory, each entry written exactly
// once, by the split that owns the tile (32 MB at the tutorial shape).
// col_sum adds the rows in row order, compensated. The per-cell sums take
// rbar's order.
//
// dm_backward's second product, [dA | dw] = P [dY | dq] (64 cells x k + 1
// per block), contracts over spots, the axis the block walks. On the FMA
// tile it went through a P tile in shared memory and a read-modify-write of
// a (nsplit, c, k + 1) partial in device memory on every spot tile. Here:
//  * The epilogue writes the tile's P (f32, 0 at spots >= s) once to a
//    padded (64 x 128) shared tile (33 KB; rows 132 words apart, so the
//    A-fragment loads hit 32 banks), and the tile's [dY | dq] rows stream
//    through the same ring a second time, as 8 chunks of 16 spots x up to
//    256 columns (rows 264 words apart, conflict-free B fragments): the
//    per-tile step sequence is the dP product's K chunks, then these 8.
//    Streaming twice costs 4 GB more L2 reads per launch at the tutorial
//    shape; keeping the tile's [dY | dq] resident for both products (128 KB
//    of f32 at 128 spots) does not fit beside A and the staging, and a
//    64-spot tile would halve the dP product's reuse of each A fragment.
//    The operand of both products is [dY | dq] (s, Kp) with Kp >= k + 1: A's
//    operand is 0 in column k, so the dP product ignores dq there.
//  * Both factors split to 3xTF32 in registers, as in the dP product, and
//    every chunk of 16 spots is summed into a fresh accumulator (6 mma, the
//    first onto zero), then added to the block's sum by a rounded f32 add:
//    P >= 0 summed over 9,852 spots is the case where a running tensor-core
//    sum was 3-6x f32's error.
//  * The block's (64 x 256) output stays in registers across all its spot
//    tiles: the 16 warps take 4 (16 cells) x 4 (64 columns), 8 mma tiles
//    and 32 accumulators a thread. The dP tile's 16 accumulators are dead
//    by then (each tile's epilogue consumes them), and dm_backward keeps no
//    per-cell stats, so the budget of 128 registers a thread (512 threads,
//    one block per SM) holds: the products take the fragment shapes of the
//    dP product, four n-tiles at a time. The output is written once per
//    block to its split's slice of the partial, which ext_reduce adds in
//    split order: no atomics, bit-identical repeats.
//  * k + 1 > 256 columns: grid.z walks output panels of 256. Each panel's
//    blocks form dP and P again (the dP product over all of K) and take
//    their panel's columns of [dY | dq]; only panel 0 stores dM.
//
// The arithmetic of the epilogue is that of the JAX kernels: grad_elem, the
// exact Adam update (eps after the sqrt), the Adafactor update as
// lr ((g rowf) colf), stored_value with per-cell-row stochastic-rounding
// keys, next stats from the stored values, PAD_GUARD sentinels out of the
// norms, dM rounded to nearest in M's type. Ragged edges: cells >= c and
// spots >= s are zero-filled in the operands' copies and never touched in
// M, mu, nu or dM.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing and returns the cudaError_t of its launches.

#include "common.cuh"

namespace {

constexpr int TC_TC = 64;       // cells per block
constexpr int TC_TS = 128;      // spots per tile
constexpr int TC_KC = 32;       // K depth of one dY stage
constexpr int TC_KACC = 16;     // K depth summed on the tensor cores at a time
constexpr int TC_STAGES = 3;    // dY ring
constexpr int TC_KRES = 256;    // K depth of the resident A panel
constexpr int TC_NJ = 2;           // 8-spot mma tiles per warp
constexpr int TC_WN = TC_TS / (8 * TC_NJ);  // spot warps, beside 2 cell warps
constexpr int TC_THREADS = 2 * TC_WN * 32;
constexpr int TC_DLD = TC_KC + 4;  // dY stage row stride, words
constexpr int TC_SLD = TC_TS + 8;  // staging row stride, entries
constexpr int TC_ROWC = 7;         // per-cell constants: m, 1/l, log l, dh, r, w, rowf
// dm_backward's second product P [dY | dq]
constexpr int TC_ES = 16;                 // spots per chunk: one fresh accumulator
constexpr int TC_EPANEL = 256;            // output columns per block (grid.z: panels)
constexpr int TC_ELD = TC_EPANEL + 8;     // chunk row stride, words
constexpr int TC_PLD = TC_TS + 4;         // P tile row stride, words
constexpr int TC_ENJ = 8;                 // 8-column mma tiles per warp
constexpr int TC_EWC = TC_EPANEL / (8 * TC_ENJ);  // column warps, beside 4 cell warps
static_assert(TC_ES * TC_ELD <= TC_TS * TC_DLD, "a chunk of [dY | dq] fits a ring slot");
static_assert((TC_TC / 16) * TC_EWC * 32 == TC_THREADS, "the second product's warps");
static_assert(TC_ES == TC_KACC, "one fresh accumulator per chunk");

// bytes of one staging tile of entries of esz bytes
__host__ __device__ inline size_t tc_stage_bytes(int esz) {
  return (size_t)TC_TC * TC_SLD * esz;
}

// bytes of dm_backward's P tile
constexpr size_t TC_P_BYTES = sizeof(float) * TC_TC * TC_PLD;

// dynamic shared memory in bytes without the staging tiles
inline size_t tc_smem_bytes(int kres) {
  return sizeof(float) * ((size_t)TC_TC * (kres + 4) + (size_t)TC_STAGES * TC_TS * TC_DLD +
                          (size_t)TC_ROWC * TC_TC);
}

enum TcEpilogue : int { TC_RBAR = 0, TC_ADAM = 1, TC_ADAFACTOR = 2, TC_DM = 3, TC_GSQ = 4 };

// Built with -DTG_DP_PROFILE (chip_smoke.py --profile), warps 0 and 15 of
// every block add the clock cycles they spend in each phase of the tile
// loop to tg_dp_clocks: 0 the last tile's epilogue and the loop's own
// bookkeeping, 1 waiting for copies and the barrier, 2 issuing the copies
// (ring and staging), 3 the products. tg_dp_profile_read returns and clears
// them. Without the flag the marks compile to nothing.
#ifdef TG_DP_PROFILE
__device__ unsigned long long tg_dp_clocks[4];
#define TG_DP_MARK(i)                  \
  {                                    \
    const long long now_ = clock64();  \
    phase_clocks[i] += now_ - last_mark; \
    last_mark = now_;                  \
  }
#else
#define TG_DP_MARK(i)
#endif

struct TcArgs {
  void* M;              // (c, s) f32 or bf16; updated in place by the updates
  const float* Aop;     // (c, Kp): A, K-major, zero-padded to Kp (multiple of 32)
  const float* dYop;    // (s, Kp): dY, K-major, zero-padded ([dY | dq] for dm)
  const float* w;       // (c,)
  const float* dq;      // (s,)
  const float* dh;      // (c,)
  const float* m;       // (c,) row max
  const float* l;       // (c,) row sum of exp
  const float* r;       // (c,) softmax-VJP row term (updates, dm)
  const float* rowf;    // (c,) Adafactor row factor
  const float* colf;    // (s,) Adafactor column factor
  void* mu;             // (c, s) Adam moments, f32 or bf16, in place
  void* nu;
  void* dM;             // (c, s) dm's gradient, in M's type
  float* row_part;      // (nsplit, c) row sums r (rbar) or sum g^2 (gsq)
  float* col_part;      // (2 ceil(c / 64), s) gsq's column sums per cell warp half
  float* st_part;       // (5, nsplit, c) next stats m, l, u, s1, s2 (updates)
  float* ext_part;      // (nsplit, c, K1) dm's [dA | dw] partials
  int c, s, Kp, kres, vec, tiles_per_split;
  int K1;                // dm: k + 1, the columns of [dA | dw]
  int cp_m, cp_mom;      // bytes per staging copy of M / of mu and nu; 0: by element
  float lr, bc1, bc2;
  float lam1, two_lam2;  // L1 and 2 * L2 strength; both 0 without norms
  int m_bf16, mom_bf16;  // M's and mu/nu's storage is bf16 (else f32)
  int sr;                // the update rounds stochastically (else to nearest)
  unsigned t;            // the step count that seeds stochastic rounding
};

// Start the copy of the (rows x cols) corner of a (c, s) array of entries of
// esz bytes, from entry `at` of its first row, into a staging tile with rows
// TC_SLD entries apart, BYTES at a time.
template <int BYTES>
__device__ __forceinline__ void stage_rows(char* tile, const char* base, size_t at, int s,
                                           int esz, int rows, int cols, int tid) {
  const int segs = TC_TS * esz / BYTES;  // per row
  const int row_bytes = cols * esz;
  for (int e = tid; e < rows * segs; e += TC_THREADS) {
    const int row = e / segs, off = (e % segs) * BYTES;
    const int n = min(BYTES, row_bytes - off);
    if (n > 0)
      cp_async_part<BYTES>(tile + (size_t)row * TC_SLD * esz + off,
                           base + (at + (size_t)row * s) * esz + off, n);
  }
}

// The same for a granule of cp bytes (16, 8, 4), or with cp == 0 entry by
// entry through registers (2-byte entries with no common alignment).
__device__ __forceinline__ void stage_tile(char* tile, const void* base, size_t at, int s,
                                           int esz, int cp, int rows, int cols, int tid) {
  const char* src = static_cast<const char*>(base);
  if (cp == 16) {
    stage_rows<16>(tile, src, at, s, esz, rows, cols, tid);
  } else if (cp == 8) {
    stage_rows<8>(tile, src, at, s, esz, rows, cols, tid);
  } else if (cp == 4) {
    stage_rows<4>(tile, src, at, s, esz, rows, cols, tid);
  } else {
    const unsigned short* g16 = static_cast<const unsigned short*>(base);
    unsigned short* t16 = reinterpret_cast<unsigned short*>(tile);
    for (int e = tid; e < rows * TC_TS; e += TC_THREADS) {
      const int row = e / TC_TS, col = e % TC_TS;
      if (col < cols) t16[row * TC_SLD + col] = g16[at + (size_t)row * s + col];
    }
  }
}

// entries col, col + 1 (col even) of a staging tile's row, as f32
__device__ __forceinline__ void staged2(const char* tile, int row, int col, bool bf16_store,
                                        float v[2]) {
  const size_t at = (size_t)row * TC_SLD + col;
  if (bf16_store) {
    const uint32_t t = *reinterpret_cast<const uint32_t*>(tile + at * 2);
    v[0] = __uint_as_float(t << 16);
    v[1] = __uint_as_float(t & 0xFFFF0000u);
  } else {
    const float2 t = *reinterpret_cast<const float2*>(tile + at * 4);
    v[0] = t.x;
    v[1] = t.y;
  }
}

// store entries at, at + 1 of an f32 (bf16_store == false) or bf16 array; a
// bf16 array takes the upper halves of v, which stored_value has made exact
// bf16 values. vec: one 8-byte (f32) or 4-byte (bf16) access.
__device__ __forceinline__ void store2(void* base, size_t at, bool bf16_store, int n_valid,
                                       bool vec, const float v[2]) {
  if (bf16_store) {
    unsigned short* p = static_cast<unsigned short*>(base) + at;
    if (vec && n_valid == 2) {
      *reinterpret_cast<uint32_t*>(p) =
          (__float_as_uint(v[0]) >> 16) | (__float_as_uint(v[1]) & 0xFFFF0000u);
    } else {
      if (n_valid > 0) p[0] = (unsigned short)(__float_as_uint(v[0]) >> 16);
      if (n_valid > 1) p[1] = (unsigned short)(__float_as_uint(v[1]) >> 16);
    }
    return;
  }
  float* p = static_cast<float*>(base) + at;
  if (vec && n_valid == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    if (n_valid > 0) p[0] = v[0];
    if (n_valid > 1) p[1] = v[1];
  }
}

template <bool WITH_DH, int EPI, bool NORMS, bool SPLIT>
__global__ void __launch_bounds__(TC_THREADS, 1)
dp_tc_kernel(const TcArgs a) {
  constexpr bool ADAM = EPI == TC_ADAM;
  constexpr bool AFAC = EPI == TC_ADAFACTOR;
  constexpr bool DM = EPI == TC_DM;
  constexpr bool GSQ = EPI == TC_GSQ;
  constexpr bool UPDATE = ADAM || AFAC;  // M in place and the next stats
  extern __shared__ __align__(16) float smem[];
  const int c = a.c, s = a.s, Kp = a.Kp, kres = a.kres;
  const int lda = kres + 4;
  const bool m_bf16 = a.m_bf16 != 0, mom_bf16 = a.mom_bf16 != 0, sr = a.sr != 0;
  const int esz_m = m_bf16 ? 2 : 4, esz_mom = mom_bf16 ? 2 : 4;
  float* As = smem;                                // [TC_TC][lda]
  float* Ds = As + TC_TC * lda;                    // [TC_STAGES][TC_TS][TC_DLD]
  float* rc = Ds + TC_STAGES * TC_TS * TC_DLD;     // [TC_ROWC][TC_TC]
  char* Ms = reinterpret_cast<char*>(rc + TC_ROWC * TC_TC);  // [TC_TC][TC_SLD] of M's type
  char* MUs = Ms + tc_stage_bytes(esz_m);          // adam: the same of mu
  char* NUs = MUs + tc_stage_bytes(esz_mom);       // and of nu
  float* Ps = reinterpret_cast<float*>(Ms + tc_stage_bytes(esz_m));  // dm: [TC_TC][TC_PLD]
  const float* __restrict__ Aop = a.Aop;
  const float* __restrict__ dYop = a.dYop;
  const bool vec = a.vec != 0;
  const bool norm_grad = a.lam1 != 0.0f || a.two_lam2 != 0.0f;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // the fragment's group and thread in group
  const int wm = warp / TC_WN;             // 2 cell halves of 32
  const int wn = warp % TC_WN;             // 8 spot parts of 16
  const int c0 = blockIdx.x * TC_TC;
  const int rows = min(TC_TC, c - c0);     // valid cells of this block
  // dm: this block's panel of [dA | dw] columns; only panel 0 stores dM
  const int col0 = blockIdx.z * TC_EPANEL;
  const int width = min(TC_EPANEL, Kp - col0);
  const bool store_dm = blockIdx.z == 0;

  // per-cell constants, read by the epilogue
  if (tid < TC_TC) {
    const int cell = c0 + tid;
    float v[TC_ROWC] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (cell < c) {
      const float l = a.l[cell];
      v[0] = a.m[cell];
      v[1] = 1.0f / l;
      v[2] = logf(l);
      if (WITH_DH) v[3] = a.dh[cell];
      if (EPI != TC_RBAR) v[4] = a.r[cell];
      v[5] = a.w[cell];
      if (AFAC) v[6] = a.rowf[cell];
    }
#pragma unroll
    for (int q = 0; q < TC_ROWC; ++q) rc[q * TC_TC + tid] = v[q];
  }
  const float inv_bc1 = 1.0f / a.bc1;
  const float inv_bc2 = 1.0f / a.bc2;

  // this thread's 4 rows: index i * 2 + h is row wm * 32 + i * 16 + h * 8 + g
  float racc[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // r (rbar), sum g^2 (gsq)
  float nm[4] = {NEG_BIG, NEG_BIG, NEG_BIG, NEG_BIG};
  float nl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float nu_[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float ns1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float ns2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  // dm: this thread's share of the block's [dA | dw] panel, in the second
  // product's fragment layout (see the header note)
  float out[TC_ENJ][4];
#pragma unroll
  for (int j = 0; j < TC_ENJ; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) out[j][q] = 0.0f;

  const int n_k = Kp / TC_KC;        // dY chunks of the dP product per tile
  const int per_tile = n_k + (DM ? TC_TS / TC_ES : 0);  // dm: then the second product's
  const int cpp = kres / TC_KC;      // chunks per A panel
  const bool resident = kres == Kp;  // one panel: A stays for every tile
  const int tile0 = blockIdx.y * a.tiles_per_split;
  const int n_tiles = max(0, min((s + TC_TS - 1) / TC_TS - tile0, a.tiles_per_split));
  const int n_steps = n_tiles * per_tile;

  // start the copy of the A panel at K offset kp (depth <= kres)
  auto load_a = [&](int kp) {
    const int segs = min(kres, Kp - kp) / 4;  // 16-byte segments per row
    for (int e = tid; e < TC_TC * segs; e += TC_THREADS) {
      const int row = e / segs, seg = e % segs;
      const bool ok = row < rows;
      cp_async_16(&As[row * lda + seg * 4],
                  ok ? Aop + (size_t)(c0 + row) * Kp + kp + seg * 4 : Aop, ok);
    }
  };
  // Start the copies of the next chunk to fetch into its ring slot (none
  // past the block's last step), and move on: chunk pf_ki of tile pf_tile,
  // a (128 spots x 32 of K) chunk of the dP product or, for dm, a (16 spots
  // x panel) chunk of the second product.
  int pf_step = 0, pf_tile = tile0, pf_ki = 0, pf_slot = 0;
  auto fetch_d = [&]() {
    const int s0 = pf_tile * TC_TS;
    const int ki = pf_ki;
    float* dst = Ds + pf_slot * (TC_TS * TC_DLD);
    const bool any = pf_step < n_steps;
    ++pf_step;
    if (++pf_ki == per_tile) {
      pf_ki = 0;
      ++pf_tile;
    }
    if (++pf_slot == TC_STAGES) pf_slot = 0;
    if (!any) return;
    if (DM && ki >= n_k) {
      const int r0 = s0 + (ki - n_k) * TC_ES;
      const int segs = width / 4;
      for (int e = tid; e < TC_ES * segs; e += TC_THREADS) {
        const int row = e / segs, seg = e % segs;
        const bool ok = r0 + row < s;
        cp_async_16(&dst[row * TC_ELD + seg * 4],
                    ok ? dYop + (size_t)(r0 + row) * Kp + col0 + seg * 4 : dYop, ok);
      }
      return;
    }
    const int k0 = ki * TC_KC;
#pragma unroll
    for (int q = 0; q < TC_TS * (TC_KC / 4) / TC_THREADS; ++q) {
      const int e = tid + q * TC_THREADS;
      const int row = e / (TC_KC / 4), seg = e % (TC_KC / 4);
      const bool ok = s0 + row < s;
      cp_async_16(&dst[row * TC_DLD + seg * 4],
                  ok ? dYop + (size_t)(s0 + row) * Kp + k0 + seg * 4 : dYop, ok);
    }
  };

  float acc[2][TC_NJ][4];
  if (n_steps > 0) load_a(0);
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < TC_STAGES - 1; ++st) {
    fetch_d();
    cp_async_commit();
  }

  // step = (tile - tile0) * per_tile + ki; a chunk ki < n_k of the dP
  // product is chunk pc of its A panel; the chunk sits in ring slot `slot`
  int tile = tile0, ki = 0, pc = 0, slot = 0;
#ifdef TG_DP_PROFILE
  long long phase_clocks[4] = {0, 0, 0, 0};
  long long last_mark = clock64();
#endif
  for (int step = 0; step < n_steps; ++step) {
    TG_DP_MARK(0)
    const int s0 = tile * TC_TS;
    const int cols = min(TC_TS, s - s0);  // valid spots of this tile
    const bool dp_chunk = !DM || ki < n_k;  // else a chunk of dm's second product
    if (ki == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < TC_NJ; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
    }
    const bool new_panel = !resident && dp_chunk && pc == 0;
    if (new_panel && step > 0) {
      __syncthreads();  // every warp is done with the panel in As
      load_a(ki * TC_KC);
      cp_async_commit();
    }
    // the copies of this step's chunk (and of a new A panel) have landed
    if (new_panel) cp_async_wait<0>();
    else cp_async_wait<TC_STAGES - 2>();
    // visible to every thread; the slot of step - 1 is free, and at a tile's
    // first chunk every warp has left the last tile's epilogue and its
    // staging tiles (dm: and the last tile's second product, and its P tile)
    __syncthreads();
    TG_DP_MARK(1)
    if (ki == 0) {
      // this tile's M (mu, nu) into the staging tiles, under the k loop
      const size_t at = (size_t)c0 * s + s0;
      stage_tile(Ms, a.M, at, s, esz_m, a.cp_m, rows, cols, tid);
      if (ADAM) {
        stage_tile(MUs, a.mu, at, s, esz_mom, a.cp_mom, rows, cols, tid);
        stage_tile(NUs, a.nu, at, s, esz_mom, a.cp_mom, rows, cols, tid);
      }
    }
    fetch_d();
    cp_async_commit();
    TG_DP_MARK(2)

    const float* Dsl = Ds + slot * (TC_TS * TC_DLD);
    const int ka = pc * TC_KC;
    const int kc = ki;  // this step's chunk of its tile
    if (++slot == TC_STAGES) slot = 0;
    if (dp_chunk && ++pc == cpp) pc = 0;
    if (++ki == per_tile) {
      ki = pc = 0;
      ++tile;
    }

    if constexpr (DM) {
      if (!dp_chunk) {
        // [dA | dw] += P [dY | dq] over this chunk's 16 spots (header note):
        // warp (wr, wc) takes cells wr*16.., columns wc*64.. of the panel
        const int wr = warp / TC_EWC, wc = warp % TC_EWC;
        const int sp = (kc - n_k) * TC_ES;  // the chunk's first spot in the tile
        uint32_t phi[2][4], plo[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            // fragment slot v: row g + 8 (v & 1), k slot t4 + 4 (v >> 1)
            const float p = Ps[(wr * 16 + g + 8 * (v & 1)) * TC_PLD + sp + ks * 8 + t4 +
                               4 * (v >> 1)];
            split_tf32(p, phi[ks][v], plo[ks][v]);
          }
#pragma unroll
        for (int jg = 0; jg < TC_ENJ; jg += 4) {
          if (wc * (8 * TC_ENJ) + jg * 8 >= width) break;  // past the panel (k small)
          uint32_t bhi[4][2][2], blo[4][2][2];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int ks = 0; ks < 2; ++ks)
#pragma unroll
              for (int v = 0; v < 2; ++v)
                split_tf32(Dsl[(ks * 8 + t4 + 4 * v) * TC_ELD + wc * (8 * TC_ENJ) +
                               (jg + jj) * 8 + g],
                           bhi[jj][ks][v], blo[jj][ks][v]);
          // the four n-tiles take each term in turn (independent products),
          // the small terms first, onto a fresh accumulator
          float tmp[4][4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_tf32_first(tmp[jj], plo[0], bhi[jj][0]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_tf32(tmp[jj], phi[0], blo[jj][0]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_tf32(tmp[jj], plo[1], bhi[jj][1]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_tf32(tmp[jj], phi[1], blo[jj][1]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_tf32(tmp[jj], phi[0], bhi[jj][0]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) mma_tf32(tmp[jj], phi[1], bhi[jj][1]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int q = 0; q < 4; ++q) out[jg + jj][q] += tmp[jj][q];
        }
        TG_DP_MARK(3)
        continue;
      }
    }

    // Each TC_KACC of K goes into fresh accumulators (tmp) and is added to
    // acc with a rounded f32 add (see the header note on truncation).
    // Which k of the chunk a fragment slot holds is free as long as A and
    // dY agree: lane t4 takes k = 8 t4 .. 8 t4 + 7 of both, as two 16-byte
    // loads a row (no bank conflicts with rows 4 words off a multiple of
    // 32), one per partial sum, whose k8 step ks uses entries 2 ks, 2 ks + 1.
    constexpr int KS = TC_KACC / 8;  // k8 steps per partial sum
    static_assert(KS == 2 && TC_KC == 32, "a lane's two 16-byte loads hold the chunk");
#pragma unroll
    for (int kk = 0; kk < TC_KC; kk += TC_KACC) {
      uint32_t ahi[KS][2][4], alo[KS][2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(
              As + (wm * 32 + i * 16 + h * 8 + g) * lda + ka + 8 * t4 + kk / 4);
          const float af[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // fragment slot h (row g + 8 h, k slot t4) and h + 2 (k slot t4 + 4)
            const int ks = q >> 1, slot = h + 2 * (q & 1);
            if constexpr (SPLIT) split_tf32(af[q], ahi[ks][i][slot], alo[ks][i][slot]);
            else ahi[ks][i][slot] = __float_as_uint(af[q]);
          }
        }
      uint32_t bhi[KS][TC_NJ][2], blo[KS][TC_NJ][2];
#pragma unroll
      for (int j = 0; j < TC_NJ; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(
            Dsl + (wn * (8 * TC_NJ) + j * 8 + g) * TC_DLD + 8 * t4 + kk / 4);
        const float bf[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ks = q >> 1, slot = q & 1;
          if constexpr (SPLIT) split_tf32(bf[q], bhi[ks][j][slot], blo[ks][j][slot]);
          else bhi[ks][j][slot] = __float_as_uint(bf[q]);
        }
      }
      // the warp's 4 mma tiles take each term in turn, so that consecutive
      // products are independent; the small terms first
      float tmp[2][TC_NJ][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < TC_NJ; ++j) {
          if constexpr (SPLIT) mma_tf32_first(tmp[i][j], alo[0][i], bhi[0][j]);
          else mma_tf32_first(tmp[i][j], ahi[0][i], bhi[0][j]);
        }
      if constexpr (SPLIT) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < TC_NJ; ++j) mma_tf32(tmp[i][j], ahi[0][i], blo[0][j]);
#pragma unroll
        for (int ks = 1; ks < KS; ++ks) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < TC_NJ; ++j) mma_tf32(tmp[i][j], alo[ks][i], bhi[ks][j]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < TC_NJ; ++j) mma_tf32(tmp[i][j], ahi[ks][i], blo[ks][j]);
        }
      }
#pragma unroll
      for (int ks = SPLIT ? 0 : 1; ks < KS; ++ks)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < TC_NJ; ++j) mma_tf32(tmp[i][j], ahi[ks][i], bhi[ks][j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < TC_NJ; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += tmp[i][j][q];
    }
    TG_DP_MARK(3)
    if (kc != n_k - 1) continue;

    // ---- the tile's epilogue, in the accumulator fragment's layout:
    // acc[i][j][h * 2 + q] is row wm*32 + i*16 + h*8 + g, column
    // wn*16 + j*8 + 2*t4 + q of the tile. With fewer chunks than stages a tile
    // the staging copies are younger than the step's wait covers.
    if (n_k < TC_STAGES) {
      cp_async_wait<0>();
      __syncthreads();
    }
    float dqv[TC_NJ][2], cfv[TC_NJ][2];
    float csum[TC_NJ][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // gsq: this tile's column sums
    int nv[TC_NJ];
#pragma unroll
    for (int j = 0; j < TC_NJ; ++j) {
      const int spot = s0 + wn * (8 * TC_NJ) + j * 8 + 2 * t4;
      nv[j] = max(0, min(2, s - spot));
      dqv[j][0] = nv[j] > 0 ? __ldg(a.dq + spot) : 0.0f;
      dqv[j][1] = nv[j] > 1 ? __ldg(a.dq + spot + 1) : 0.0f;
      if (AFAC) {
        cfv[j][0] = nv[j] > 0 ? __ldg(a.colf + spot) : 0.0f;
        cfv[j][1] = nv[j] > 1 ? __ldg(a.colf + spot + 1) : 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ri = i * 2 + h;
        const int rl = wm * 32 + i * 16 + h * 8 + g;
        const int cell = c0 + rl;
        if (cell >= c) continue;  // (dm: rows of P the block never outputs)
        const size_t row = (size_t)cell * s;
        const float cm = rc[rl], cinvl = rc[TC_TC + rl], clogl = rc[2 * TC_TC + rl];
        const float cdh = rc[3 * TC_TC + rl], cr = rc[4 * TC_TC + rl];
        const float cw = rc[5 * TC_TC + rl], crf = rc[6 * TC_TC + rl];
        // stochastic-rounding keys of this cell's M, mu and nu (salts 1, 2, 3)
        uint32_t key_m = 0, key_mu = 0, key_nu = 0;
        if (UPDATE && sr) key_m = sr_key(a.t, (uint32_t)cell, 1u);
        if (ADAM && sr) {
          key_mu = sr_key(a.t, (uint32_t)cell, 2u);
          key_nu = sr_key(a.t, (uint32_t)cell, 3u);
        }
#pragma unroll
        for (int j = 0; j < TC_NJ; ++j) {
          const int col = wn * (8 * TC_NJ) + j * 8 + 2 * t4;
          if (DM) {
            // P of spots >= s is 0: the second product sums over the tile
            float pv[2] = {0.0f, 0.0f}, dmv[2];
            if (nv[j] > 0) {
              float x[2];
              staged2(Ms, rl, col, m_bf16, x);
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                if (q >= nv[j]) continue;
                const float P = expf(x[q] - cm) * cinvl;
                float dP = fmaf(cw, dqv[j][q], acc[i][j][h * 2 + q]);
                if (WITH_DH) dP += cdh * ((x[q] - cm - clogl) + 1.0f);
                pv[q] = P;
                dmv[q] = stored_value(P * (dP - cr), m_bf16, false, 0u, 0);
              }
              if (store_dm) store2(a.dM, row + s0 + col, m_bf16, nv[j], vec, dmv);
            }
            *reinterpret_cast<float2*>(Ps + rl * TC_PLD + col) = make_float2(pv[0], pv[1]);
            continue;
          }
          if (nv[j] <= 0) continue;
          const int spot = s0 + col;
          float x[2], mv[2], vv[2];
          staged2(Ms, rl, col, m_bf16, x);
          if (ADAM) {
            staged2(MUs, rl, col, mom_bf16, mv);
            staged2(NUs, rl, col, mom_bf16, vv);
          }
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            if (q >= nv[j]) continue;
            const float xq = x[q];
            const float P = expf(xq - cm) * cinvl;
            float dP = fmaf(cw, dqv[j][q], acc[i][j][h * 2 + q]);
            if (WITH_DH) dP += cdh * ((xq - cm - clogl) + 1.0f);
            if constexpr (GSQ) {
              const float gr = grad_elem(P, dP, cr, xq, a.lam1, a.two_lam2, norm_grad);
              const float g2 = gr * gr;
              racc[ri] += g2;
              csum[j][q] += g2;
            } else if constexpr (!UPDATE) {
              racc[ri] = fmaf(P, dP, racc[ri]);
            } else {
              const float gr = grad_elem(P, dP, cr, xq, a.lam1, a.two_lam2, norm_grad);
              float xn;
              if constexpr (ADAM) {
                const float mun = BETA1 * mv[q] + ONE_MINUS_BETA1 * gr;
                const float nun = BETA2 * vv[q] + ONE_MINUS_BETA2 * (gr * gr);
                const float m_hat = mun * inv_bc1;
                const float v_hat = nun * inv_bc2;
                xn = xq - a.lr * m_hat / (sqrtf(v_hat) + ADAM_EPS);
                mv[q] = stored_value(mun, mom_bf16, sr, key_mu, spot + q);
                vv[q] = stored_value(nun, mom_bf16, sr, key_nu, spot + q);
              } else {
                xn = xq - a.lr * ((gr * crf) * cfv[j][q]);
              }
              x[q] = stored_value(xn, m_bf16, sr, key_m, spot + q);
              // the next stats see the stored value
              stats_push(nm[ri], nl[ri], nu_[ri], x[q]);
              if (NORMS) norms_push(ns1[ri], ns2[ri], x[q]);
            }
          }
          if (UPDATE) store2(a.M, row + spot, m_bf16, nv[j], vec, x);
          if (ADAM) {
            store2(a.mu, row + spot, mom_bf16, nv[j], vec, mv);
            store2(a.nu, row + spot, mom_bf16, nv[j], vec, vv);
          }
        }
      }
    }
    if constexpr (GSQ) {
      // the column sums over the warp's 32 cells (lane bits 2-4 are the
      // fragment's group g), written once from lanes 0-3 into this cell
      // half's row of the partial (header note)
#pragma unroll
      for (int j = 0; j < TC_NJ; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            csum[j][q] += __shfl_xor_sync(0xffffffffu, csum[j][q], off);
      if (g == 0) {
        float* part = a.col_part + (size_t)(blockIdx.x * 2 + wm) * s + s0;
#pragma unroll
        for (int j = 0; j < TC_NJ; ++j)
          store2(part, wn * (8 * TC_NJ) + j * 8 + 2 * t4, false, nv[j], vec, csum[j]);
      }
    }
  }

  TG_DP_MARK(0)
#ifdef TG_DP_PROFILE
  if (lane == 0 && (warp == 0 || warp == 15))
    for (int q = 0; q < 4; ++q) atomicAdd(&tg_dp_clocks[q], (unsigned long long)phase_clocks[q]);
#endif
  cp_async_wait<0>();
  if constexpr (DM) {
    // the block's share of [dA | dw], once, into its split's slice; a split
    // with no spot tiles writes zeros
    const int wr = warp / TC_EWC, wc = warp % TC_EWC;
#pragma unroll
    for (int j = 0; j < TC_ENJ; ++j) {
      const int col = col0 + wc * (8 * TC_ENJ) + j * 8 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cell = c0 + wr * 16 + g + 8 * h;
        if (cell >= c) continue;
        float* o = a.ext_part + ((size_t)blockIdx.y * c + cell) * a.K1;
        if (col < a.K1) o[col] = out[j][2 * h];
        if (col + 1 < a.K1) o[col + 1] = out[j][2 * h + 1];
      }
    }
    return;
  }
  // ---- per-cell results: over the quad's 4 lanes by shuffle, then over the
  // 8 spot warps through shared memory in warp order
  __syncthreads();  // the ring is free: its first words hold the warps' partials
  float* red = Ds;  // [5][TC_WN][TC_TC]
  constexpr int PLANE = TC_WN * TC_TC;
#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    if (!UPDATE) racc[ri] = sum_reduce(racc[ri], 4);
    if (UPDATE) {
      stats_reduce(nm[ri], nl[ri], nu_[ri], 4);
      if (NORMS) {
        ns1[ri] = sum_reduce(ns1[ri], 4);
        ns2[ri] = sum_reduce(ns2[ri], 4);
      }
    }
    if (t4 == 0) {
      const int rl = wm * 32 + (ri >> 1) * 16 + (ri & 1) * 8 + g;
      const int at = wn * TC_TC + rl;
      if (!UPDATE) red[at] = racc[ri];
      if (UPDATE) {
        red[at] = nm[ri];
        red[PLANE + at] = nl[ri];
        red[2 * PLANE + at] = nu_[ri];
        if (NORMS) {
          red[3 * PLANE + at] = ns1[ri];
          red[4 * PLANE + at] = ns2[ri];
        }
      }
    }
  }
  __syncthreads();
  if (tid < TC_TC && c0 + tid < c) {
    const size_t plane = (size_t)gridDim.y * c;
    const size_t out_at = (size_t)blockIdx.y * c + (c0 + tid);
    if (!UPDATE) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < TC_WN; ++q) v += red[q * TC_TC + tid];
      a.row_part[out_at] = v;
    } else {
      float mm = NEG_BIG, ll = 0.0f, uu = 0.0f, s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int q = 0; q < TC_WN; ++q) {
        const int at = q * TC_TC + tid;
        stats_merge(mm, ll, uu, red[at], red[PLANE + at], red[2 * PLANE + at]);
        if (NORMS) {
          s1 += red[3 * PLANE + at];
          s2 += red[4 * PLANE + at];
        }
      }
      a.st_part[out_at] = mm;
      a.st_part[plane + out_at] = ll;
      a.st_part[2 * plane + out_at] = uu;
      if (NORMS) {
        a.st_part[3 * plane + out_at] = s1;
        a.st_part[4 * plane + out_at] = s2;
      }
    }
  }
}

template <int EPI, bool NORMS>
cudaError_t launch_tc_kernel(bool with_dh, bool split, const TcArgs& a, dim3 grid,
                             cudaStream_t st) {
  void (*kernel)(const TcArgs);
  if constexpr (EPI == TC_DM) {
    // the backward's A and dY are f32: always three TF32 products
    if (!split) return cudaErrorInvalidValue;
    kernel = with_dh ? dp_tc_kernel<true, EPI, NORMS, true>
                     : dp_tc_kernel<false, EPI, NORMS, true>;
  } else {
    kernel = with_dh ? (split ? dp_tc_kernel<true, EPI, NORMS, true>
                              : dp_tc_kernel<true, EPI, NORMS, false>)
                     : (split ? dp_tc_kernel<false, EPI, NORMS, true>
                              : dp_tc_kernel<false, EPI, NORMS, false>);
  }
  size_t smem = tc_smem_bytes(a.kres) + tc_stage_bytes(a.m_bf16 ? 2 : 4);
  if (EPI == TC_ADAM) smem += 2 * tc_stage_bytes(a.mom_bf16 ? 2 : 4);
  if (EPI == TC_DM) smem += TC_P_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<TcArgs*>(&a)};
  err = cudaLaunchKernel((const void*)kernel, grid, dim3(TC_THREADS), args, smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the fields every entry point sets; tiles_per_split and kres from the shape
TcArgs tc_args(const void* M, const float* Aop, const float* dYop, const float* w,
               const float* dq, const float* dh, const float* m, const float* l, int c,
               int s, int Kp, int vec, int nsplit, int m_bf16, int cp_m) {
  TcArgs a = {};
  a.M = const_cast<void*>(M);
  a.Aop = Aop;
  a.dYop = dYop;
  a.w = w;
  a.dq = dq;
  a.dh = dh;
  a.m = m;
  a.l = l;
  a.c = c;
  a.s = s;
  a.Kp = Kp;
  a.kres = Kp < TC_KRES ? Kp : TC_KRES;
  a.vec = vec;
  a.m_bf16 = m_bf16;
  a.cp_m = cp_m;
  a.bc1 = a.bc2 = 1.0f;
  const int n_tiles = (s + TC_TS - 1) / TC_TS;
  a.tiles_per_split = (n_tiles + nsplit - 1) / nsplit;
  return a;
}

// a staging copy granule the kernel takes: 16, 8 or 4 bytes, or 0 (by
// element) for 2-byte entries only
bool tc_granule_ok(int cp, int bf16_store) {
  return cp == 16 || cp == 8 || cp == 4 || (cp == 0 && bf16_store);
}

// vc[spot] = the sum of gsq's (rows, s) column partials, in row order, with
// Kahan's compensation: a plain running sum over the 814 rows of the
// tutorial shape errs 10 times as much as the f32 twin's reduction
// (against float64, on the H100); compensated, the sum is exact to about an
// ulp and the partials' own rounding is what remains
__global__ void col_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                               int rows, int s) {
  const int spot = blockIdx.x * blockDim.x + threadIdx.x;
  if (spot >= s) return;
  float acc = 0.0f, comp = 0.0f;
  for (int r = 0; r < rows; ++r) {
    const float y = __fsub_rn(part[(size_t)r * s + spot], comp);
    const float t = __fadd_rn(acc, y);
    comp = __fsub_rn(__fsub_rn(t, acc), y);
    acc = t;
  }
  out[spot] = acc;
}

// the update kernels' launch and the merge of their next stats (and norms)
template <int EPI>
cudaError_t launch_update(bool with_dh, bool with_norms, bool split, const TcArgs& a,
                          int nsplit, float* m_out, float* l_out, float* u_out,
                          float* s1_out, float* s2_out, cudaStream_t st) {
  const dim3 grid((a.c + TC_TC - 1) / TC_TC, nsplit);
  const int merge_blocks = (a.c + 255) / 256;
  cudaError_t err;
  if (with_norms) {
    err = launch_tc_kernel<EPI, true>(with_dh, split, a, grid, st);
    if (err != cudaSuccess) return err;
    dp_merge_kernel<true, true><<<merge_blocks, 256, 0, st>>>(
        a.st_part, m_out, l_out, u_out, s1_out, s2_out, a.c, nsplit);
  } else {
    err = launch_tc_kernel<EPI, false>(with_dh, split, a, grid, st);
    if (err != cudaSuccess) return err;
    dp_merge_kernel<true, false><<<merge_blocks, 256, 0, st>>>(
        a.st_part, m_out, l_out, u_out, nullptr, nullptr, a.c, nsplit);
  }
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes).
//
// Shared arguments: Aop (c, Kp) = A and dYop (s, Kp) = dY, f32, row-major
// (K-major), columns k..Kp-1 zero, Kp a positive multiple of 32, both
// 16-byte aligned; split != 0: the operands are arbitrary f32 and the tile
// takes three TF32 products of their hi/lo parts; split == 0: every operand
// value is exact in TF32 (bf16 values under a bf16 compute type) and one
// product is exact. w (c,) and dq (s,): the rank-one term, added in f32.
// dh, m, l, r: (c,). vec != 0 allows 8-byte (f32) or 4-byte (bf16) stores
// of 2 entries along spots of M, mu, nu, dM (s even and every base aligned
// so). cp_m (cp_mom): the bytes per asynchronous staging copy of M (of mu
// and nu): 16, 8 or 4, dividing the row length in bytes and the base
// address; 0 copies a bf16 array entry by entry. nsplit: spot-axis splits
// (grid.y). lam1 and two_lam2: the L1 strength and twice the L2 strength;
// m_bf16 (and mom_bf16): M's (mu's and nu's) storage is bf16; sr: the update
// stores by stochastic rounding seeded by step t (else round to nearest
// even).
// ---------------------------------------------------------------------------

// r_part: (nsplit, c) scratch; r: (c,)
extern "C" int tg_rbar(const void* M, const float* Aop, const float* dYop, const float* w,
                       const float* dq, const float* dh, const float* m, const float* l,
                       float* r_part, float* r, int c, int s, int Kp, int with_dh,
                       int vec, int nsplit, int m_bf16, int split, int cp_m,
                       void* stream) {
  if (Kp <= 0 || Kp % TC_KC != 0 || !tc_granule_ok(cp_m, m_bf16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  TcArgs a = tc_args(M, Aop, dYop, w, dq, dh, m, l, c, s, Kp, vec, nsplit, m_bf16, cp_m);
  a.row_part = r_part;
  const dim3 grid((c + TC_TC - 1) / TC_TC, nsplit);
  const cudaError_t err =
      launch_tc_kernel<TC_RBAR, false>(with_dh != 0, split != 0, a, grid, st);
  if (err != cudaSuccess) return (int)err;
  dp_merge_kernel<false, false><<<(c + 255) / 256, 256, 0, st>>>(
      r_part, r, nullptr, nullptr, nullptr, nullptr, c, nsplit);
  return (int)cudaGetLastError();
}

// r: (c,) from tg_rbar with the same dh; lam1 and two_lam2 as for the
// updates; vr_part: (nsplit, c) and vc_part: (2 ceil(c / 64), s) scratch
// (vec != 0 also allows 8-byte stores of vc_part); vr: (c,) = the sum over
// spots of g^2; vc: (s,) = the sum over cells of g^2. M is only read.
extern "C" int tg_gsq_tc(const void* M, const float* Aop, const float* dYop, const float* w,
                         const float* dq, const float* dh, const float* m, const float* l,
                         const float* r, float* vr_part, float* vc_part, float* vr,
                         float* vc, int c, int s, int Kp, int with_dh, float lam1,
                         float two_lam2, int vec, int nsplit, int m_bf16, int split, int cp_m,
                         void* stream) {
  if (Kp <= 0 || Kp % TC_KC != 0 || !tc_granule_ok(cp_m, m_bf16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  TcArgs a = tc_args(M, Aop, dYop, w, dq, dh, m, l, c, s, Kp, vec, nsplit, m_bf16, cp_m);
  a.r = r;
  a.row_part = vr_part;
  a.col_part = vc_part;
  a.lam1 = lam1;
  a.two_lam2 = two_lam2;
  const int groups = (c + TC_TC - 1) / TC_TC;
  const cudaError_t err = launch_tc_kernel<TC_GSQ, false>(
      with_dh != 0, split != 0, a, dim3(groups, nsplit), st);
  if (err != cudaSuccess) return (int)err;
  dp_merge_kernel<false, false><<<(c + 255) / 256, 256, 0, st>>>(
      vr_part, vr, nullptr, nullptr, nullptr, nullptr, c, nsplit);
  if (s > 0) col_sum_kernel<<<(s + 255) / 256, 256, 0, st>>>(vc_part, vc, 2 * groups, s);
  return (int)cudaGetLastError();
}

// M, mu, nu: (c, s), updated in place; st_part: (5, nsplit, c) scratch;
// m_out, l_out, u_out [, s1_out, s2_out when with_norms]: (c,) stats of the
// stored M.
extern "C" int tg_dm_adam(void* M, const float* Aop, const float* dYop, const float* w,
                          const float* dq, const float* dh, const float* m, const float* l,
                          const float* r, void* mu, void* nu, float* st_part,
                          float* m_out, float* l_out, float* u_out, float* s1_out,
                          float* s2_out, int c, int s, int Kp, int with_dh,
                          int with_norms, float lr, float bc1, float bc2, float lam1,
                          float two_lam2, int vec, int nsplit, int m_bf16,
                          int mom_bf16, int sr, int t, int split, int cp_m, int cp_mom,
                          void* stream) {
  if (Kp <= 0 || Kp % TC_KC != 0 || !tc_granule_ok(cp_m, m_bf16) ||
      !tc_granule_ok(cp_mom, mom_bf16))
    return (int)cudaErrorInvalidValue;
  TcArgs a = tc_args(M, Aop, dYop, w, dq, dh, m, l, c, s, Kp, vec, nsplit, m_bf16, cp_m);
  a.r = r;
  a.mu = mu;
  a.nu = nu;
  a.st_part = st_part;
  a.cp_mom = cp_mom;
  a.lr = lr;
  a.bc1 = bc1;
  a.bc2 = bc2;
  a.lam1 = lam1;
  a.two_lam2 = two_lam2;
  a.mom_bf16 = mom_bf16;
  a.sr = sr;
  a.t = (unsigned)t;
  return (int)launch_update<TC_ADAM>(with_dh != 0, with_norms != 0, split != 0, a, nsplit,
                                     m_out, l_out, u_out, s1_out, s2_out,
                                     (cudaStream_t)stream);
}

// M: (c, s), updated in place; rowf: (c,); colf: (s,); st_part and the stats
// outputs as for tg_dm_adam
extern "C" int tg_dm_adafactor_tc(void* M, const float* Aop, const float* dYop,
                                  const float* w, const float* dq, const float* dh,
                                  const float* m, const float* l, const float* r,
                                  const float* rowf, const float* colf, float* st_part,
                                  float* m_out, float* l_out, float* u_out, float* s1_out,
                                  float* s2_out, int c, int s, int Kp, int with_dh,
                                  int with_norms, float lr, float lam1, float two_lam2,
                                  int vec, int nsplit, int m_bf16, int sr, int t, int split,
                                  int cp_m, void* stream) {
  if (Kp <= 0 || Kp % TC_KC != 0 || !tc_granule_ok(cp_m, m_bf16))
    return (int)cudaErrorInvalidValue;
  TcArgs a = tc_args(M, Aop, dYop, w, dq, dh, m, l, c, s, Kp, vec, nsplit, m_bf16, cp_m);
  a.r = r;
  a.rowf = rowf;
  a.colf = colf;
  a.st_part = st_part;
  a.lr = lr;
  a.lam1 = lam1;
  a.two_lam2 = two_lam2;
  a.sr = sr;
  a.t = (unsigned)t;
  return (int)launch_update<TC_ADAFACTOR>(with_dh != 0, with_norms != 0, split != 0, a,
                                          nsplit, m_out, l_out, u_out, s1_out, s2_out,
                                          (cudaStream_t)stream);
}

// dYEop: (s, Kp) = [dY | dq], zero-padded, Kp >= k + 1 (column k of Aop is
// 0); r: (c,) from tg_rbar with the same dh; dM: (c, s) = P (dP - r) in M's
// type, rounded to nearest; ext_part: (nsplit, c, k + 1) scratch; dA: (c, k)
// = P dY; dw: (c,) = P dq
extern "C" int tg_dm_backward_tc(const void* M, const float* Aop, const float* dYEop,
                                 const float* w, const float* dq, const float* dh,
                                 const float* m, const float* l, const float* r, void* dM,
                                 float* ext_part, float* dA, float* dw, int c, int s, int k,
                                 int Kp, int with_dh, int vec, int nsplit, int m_bf16,
                                 int cp_m, void* stream) {
  if (Kp <= k || Kp % TC_KC != 0 || !tc_granule_ok(cp_m, m_bf16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  TcArgs a = tc_args(M, Aop, dYEop, w, dq, dh, m, l, c, s, Kp, vec, nsplit, m_bf16, cp_m);
  a.r = r;
  a.dM = dM;
  a.ext_part = ext_part;
  a.K1 = k + 1;
  const dim3 grid((c + TC_TC - 1) / TC_TC, nsplit, (Kp + TC_EPANEL - 1) / TC_EPANEL);
  const cudaError_t err = launch_tc_kernel<TC_DM, false>(with_dh != 0, true, a, grid, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_ext_reduce(ext_part, dA, dw, c, k, nsplit, st);
}


#ifdef TG_DP_PROFILE
// out[4]: the phase clocks summed since the last call (synchronises)
extern "C" int tg_dp_profile_read(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, tg_dp_clocks, sizeof(tg_dp_clocks));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(tg_dp_clocks, zero, sizeof(zero));
  return (int)err;
}
#endif
