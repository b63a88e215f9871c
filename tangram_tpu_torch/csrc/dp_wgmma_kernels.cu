// rbar's dP tile on Hopper's warpgroup MMA (sm_90a): a persistent kernel
// with TMA-fed dY rings and wgmma.
//
//   tg_rbar_wgmma        replaces tangram_tpu/ops/fused_step.py::_rbar (kernel
//                        pallas_core._rbar_kernel / _dp_tile), also as the
//                        first pass of pallas_core._backward, at K depths up
//                        to 256
//   tg_dp_wgmma_operand  lays dY out for it (no TPU counterpart: the JAX
//                        kernels read dY as it is)
//
// It forms dP = A dY^T + w (x) dq [+ dh (x) (log P + 1)] tile by tile, never
// stores it, and sums r_c = sum_s P dP per cell. dp_tensor_kernels.cu keeps
// rbar past K = 256 and every other epilogue, the fused Adam update
// included (see below).
//
// What bounds it on the H100, at 26,431 x 9,852 x 249 (K padded to 256).
// The f32 product is three TF32 products (below): 3.9e11 flops, 0.78 ms at
// the card's 495 TFLOP/s; rbar reads M once (1.04 GB, 0.31 ms), so
// operations bound it. In bf16 the product is one exact pass at 989
// TFLOP/s (0.13 ms) and M's read (0.16 ms) bounds it. The mma.sync tile of
// dp_tensor_kernels.cu took 3.4 ms in f32 and 2.6 ms in bf16: mma.sync runs
// at a quarter of the TF32 peak, and every warp issues its own copies.
//
// The design.
//  * Persistent blocks, one per SM, of three warpgroups: two consumers
//    (warps 0-3 and 4-7) and a producer warpgroup whose warps 8 and 9 feed
//    one consumer's dY ring each (setmaxnreg moves the producers' registers
//    to the consumers). The (64-cell group, 64-spot tile) pairs are cut into
//    units, (group, spot split) runs of tiles_per_split tiles, and block b
//    walks the units [b U / grid, (b + 1) U / grid): consecutive units
//    mostly share a group, and the group's A panel stays in shared memory
//    until the group changes (both consumers meet at a named barrier and
//    copy the next panel).
//  * Two consumers, each on its own tiles. The block's tiles alternate
//    between them (tile j of the block goes to warpgroup j & 1), each with
//    its own ring, so neither waits for the other: while one runs its
//    tile's wgmma product the other may run its epilogue, and the tensor
//    cores take the products of both. Each tile is 64 cells x 64 spots:
//    wgmma m64n64, 32 f32 accumulators a thread. (One ring shared by both
//    consumers needs their products to take turns: a consumer that skips
//    the other's stages can wait on a barrier two phases ahead, where the
//    parity of an older phase passes.)
//  * The dY rings. A producer lane copies each (64 spots x 32 of K) stage
//    of its consumer's tiles with one bulk TMA copy into that consumer's
//    ring (2 to 16 slots, full and empty mbarriers); the stages are laid
//    out by tg_dp_wgmma_operand once per step, already in wgmma's
//    shared-memory layout, so one copy fills a slot. The consumer releases
//    a slot when the wgmma groups that read it have completed.
//  * f32 accuracy (3xTF32), as dp_tensor_kernels.cu: hi = tf32(x),
//    lo = x - hi, lo*hi + hi*lo + hi*hi, the small terms first, and every 16
//    of K into a fresh accumulator added to the tile's sum by a rounded f32
//    add, in K order. dY is split once per step by tg_dp_wgmma_operand (hi
//    and lo stages side by side: 16 KB a stage). A stays as the f32 operand
//    in the panel (64 x Kp + 4 words a row, conflict-free 16-byte loads) and
//    is split in registers by Veltkamp's product when a thread loads its
//    fragment: wgmma takes A from registers, so A needs no second copy,
//    neither in shared memory (hi and lo of a 64 x 256 panel are 128 KB) nor
//    in device memory. A chunk's two 16-deep groups are issued together,
//    each into its own fresh accumulator, and added once both are done (one
//    wgmma wait a chunk: waiting after each group, with one group in flight
//    while the last was added, measured 10% slower).
//  * bf16 operands (A and dY both bf16): wgmma m64n64k16 on bf16, exact
//    products summed on the tensor cores over all of K, a chunk a wgmma
//    group, the next chunk's group issued before the last one's wait (at
//    the tutorial shape its r matched the f32 twin as closely as with a
//    fresh accumulator per 16 of K, which costs a wait a chunk: below). The
//    panel holds A in bf16 (converted from its exact f32 copy when it is
//    loaded), the stages dY's bf16 (4 KB a stage): a quarter of the L2
//    traffic of the f32 stages.
//    The order of K within each 32-wide chunk is permuted so that a thread's
//    A fragment of two 16-deep steps is one 16-byte load per row; the
//    operand's layout applies the same permutation to dY (wg_perm, and
//    wgmma_operand_plain in ops/cuda_core.py).
//  * M under the product. When a consumer finishes a tile's epilogue it
//    starts the loads of its next tile's M (and dq) into registers, in the
//    accumulator's layout (32 words a thread); they land while the next
//    product runs, and the epilogue reads no shared memory.
//  * The epilogue: P dP summed per cell, dP with w dq and dh as
//    dp_tensor_kernels.cu forms them. In the accumulator's layout a cell row
//    lies in one quad of one warp, so a (unit, warpgroup) pair's per-cell
//    sums are reduced by shuffles over the quad and written once to their
//    own row of a (2 nsplit, c) partial, which dp_merge adds in row order: no
//    atomics, bit-identical repeats on one card (the cut into units follows
//    the card's SM count). Its columns go two 8-spot steps at a time, in a
//    loop: unrolled over a thread's 32 entries, the Adam body took ten times
//    its arithmetic's time (the two warpgroups run different code, and that
//    much of it thrashes the instruction cache).
//
// Where it stands (one H100 SXM 80GB, 700 W, at the tutorial shape): 2.6 ms
// a launch in f32 and 1.7 ms in bf16, against the tile's 3.4 and 2.6 and the
// bounds of 0.78 and 0.16 ms. A chunk's wgmma group gives its accumulators
// back about 1,000 cycles after its issue (clock64 around the loop's steps),
// whatever its work (2 bf16 or 12 TF32 products: 64 or 384 cycles of the
// tensor cores). In f32 a warpgroup holds one group in flight: a second set
// of fresh accumulators and A fragments (64 more registers a thread) does
// not fit beside the M and dq words; in bf16 it holds two. So the loop is
// bound by that latency, two warpgroups deep, and not by the tensor cores.
//
// The fused Adam update was built on this loop too, with mu and nu staged by
// the consumers and M in registers, and measured 6.5 ms (f32) and 6.9 ms
// (bf16) a launch at the tutorial shape against the mma.sync tile's 5.4 and
// 4.6: its epilogue, on two warpgroups where the tile has sixteen warps,
// stays latency-bound. dm_adam therefore stays on dp_tensor_kernels.cu.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing and returns the cudaError_t of its launches.

#include "common.cuh"

namespace {

constexpr int WG_CELLS = 64;      // cells per group: wgmma's M
constexpr int WG_SPOTS = 64;      // spots per tile: wgmma's N
constexpr int WG_KC = 32;         // K depth of one dY stage
constexpr int WG_KMAX = 256;      // deepest K of the resident A panel
constexpr int WG_MAX_STAGES = 16;  // slots of each consumer's dY ring at most
constexpr int WG_CONSUMER_THREADS = 256;  // two warpgroups
constexpr int WG_THREADS = WG_CONSUMER_THREADS + 128;  // + the producer warpgroup
constexpr int WG_PRODUCER_REGS = 40;   // setmaxnreg: 128 x 40 + 256 x 232 <= 65,536
constexpr int WG_CONSUMER_REGS = 232;
constexpr int WG_BAR_BYTES = 512;   // the mbarriers, at the start of shared memory
constexpr int WG_SMEM_MAX = 232448;  // what a block may have on the H100
constexpr int WG_BAR_PANEL = 1;     // named barrier of both consumers

// bytes of one dY stage: hi and lo f32 (split) or bf16
__host__ __device__ inline int wg_stage_bytes(bool split) {
  return split ? 2 * WG_SPOTS * WG_KC * 4 : WG_SPOTS * WG_KC * 2;
}

// the A panel's row stride in 4-byte words: f32 Kp + 4 (rows 4 banks apart:
// the 16-byte fragment loads of a quarter warp hit 32 banks); bf16 16 words
// past a multiple of 32 (rows 16 banks apart, the same for 8-entry loads)
__host__ __device__ inline int wg_a_words(int Kp, bool split) {
  return split ? Kp + 4 : (Kp / 2 + 31) / 32 * 32 + 16;
}

struct WgArgs {
  const void* M;         // (c, s) f32 or bf16
  const float* Aop;      // (c, Kp): A, K-major, zero-padded, f32 (bf16 values when !split)
  const void* dYt;       // dY's stages from tg_dp_wgmma_operand
  const float* w;        // (c,)
  const float* dq;       // (s,)
  const float* dh;       // (c,)
  const float* m;        // (c,) row max
  const float* l;        // (c,) row sum of exp
  float* row_part;       // (2 nsplit, c) the row sums
  int c, s, Kp, vec, nsplit, tiles_per_split, stages, m_bf16;
};

// ---------------------------------------------------------------------------
// mbarriers, bulk copies, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of the given parity has completed; a wait that
// outlasts 2^26 polls (a second or more, where a tile takes microseconds) is
// a fault of the pipeline and traps, so the launch fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// global -> shared, completing as transactions on the barrier
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// wgmma's shared-memory descriptor of a K-major operand without swizzle:
// 8 x 16-byte core matrices, 1,024 bytes apart along K (LBO), 128 along N
// (SBO), as tg_dp_wgmma_operand lays each stage out
__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads of an accumulator across a wait
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_D32_OPS(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d (+)= a b: a 64 x 8 TF32 tile from registers (mma.m16n8k8's A fragment
// per warp), b 8 x 64 from shared memory; scale_d == 0 starts from zero
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// the same for a 64 x 16 bf16 A (mma.m16n8k16's fragment) and 16 x 64 B
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : WG_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// M's words and the walk over the tiles
// ---------------------------------------------------------------------------

// Start the loads of entries at, at + 1 (the first n_valid) of an f32 or
// bf16 array into two words, to be read by unpack2 once they have landed:
// f32 a word each (one 8-byte load when vec); bf16 a 16-bit entry per word.
// (A bf16 pair read as one 4-byte word and split after it landed gave wrong
// values on the H100, at every shape with an even s; not understood.)
__device__ __forceinline__ void load2(const void* base, size_t at, bool bf16, int n_valid,
                                      bool vec, uint32_t w[2]) {
  w[0] = w[1] = 0u;
  if (n_valid <= 0) return;
  if (bf16) {
    const unsigned short* p = static_cast<const unsigned short*>(base) + at;
    w[0] = p[0];
    if (n_valid > 1) w[1] = p[1];
    return;
  }
  const uint32_t* p = static_cast<const uint32_t*>(base) + at;
  if (vec && n_valid == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = p[0];
    if (n_valid > 1) w[1] = p[1];
  }
}

__device__ __forceinline__ void unpack2(const uint32_t w[2], bool bf16, float v[2]) {
  v[0] = __uint_as_float(bf16 ? w[0] << 16 : w[0]);
  v[1] = __uint_as_float(bf16 ? w[1] << 16 : w[1]);
}

// a position in a block's walk over its units' tiles: unit u, spot tile t,
// and j, the tile's index in the block's walk
struct TileWalk {
  int u, t, j;
};

// the next tile of the walk; u reaches u1 past the last
__device__ __forceinline__ void walk_next(TileWalk& w, int u1, int nsplit, int per,
                                          int n_tiles) {
  ++w.t;
  ++w.j;
  while (w.u < u1 && w.t >= min((w.u % nsplit) * per + per, n_tiles)) {
    ++w.u;
    w.t = (w.u % nsplit) * per;
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <bool WITH_DH, bool SPLIT>
__global__ void __launch_bounds__(WG_THREADS, 1) dp_wgmma_kernel(const WgArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);   // [2][WG_MAX_STAGES]
  uint64_t* empty = full + 2 * WG_MAX_STAGES;           // [2][WG_MAX_STAGES]
  const int c = a.c, s = a.s, Kp = a.Kp, S = a.stages;  // S: slots of each ring
  const int stage_bytes = wg_stage_bytes(SPLIT);
  unsigned char* ring = smem + WG_BAR_BYTES;             // [2][S] stages
  const int a_words = wg_a_words(Kp, SPLIT);
  float* As = reinterpret_cast<float*>(ring + (size_t)2 * S * stage_bytes);
  const bool m_bf16 = a.m_bf16 != 0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int i = 0; i < 2 * WG_MAX_STAGES; ++i) {
      if (i % WG_MAX_STAGES >= S) continue;
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_k = Kp / WG_KC;
  const int n_tiles = (s + WG_SPOTS - 1) / WG_SPOTS;
  const int per = a.tiles_per_split, nsplit = a.nsplit;
  const int units = ((c + WG_CELLS - 1) / WG_CELLS) * nsplit;
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  // the walk's first tile
  TileWalk first = {u0, (u0 % nsplit) * per - 1, -1};
  walk_next(first, u1, nsplit, per, n_tiles);

  if (warp >= 8) {
    // ---- the producers: lane 0 of warp 8 + wg fills consumer wg's ring;
    // its n-th tile's stage ki is fill n n_k + ki, in slot fill % S
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(WG_PRODUCER_REGS));
    if (warp > 9 || lane != 0) return;
    const int wg = warp - 8;
    const char* dYt = static_cast<const char*>(a.dYt);
    unsigned char* my_ring = ring + (size_t)wg * S * stage_bytes;
    int f = 0;
    for (TileWalk w = first; w.u < u1; walk_next(w, u1, nsplit, per, n_tiles)) {
      if ((w.j & 1) != wg) continue;
      for (int ki = 0; ki < n_k; ++ki, ++f) {
        const int slot = f % S, round = f / S;
        uint64_t* bar = &full[wg * WG_MAX_STAGES + slot];
        if (round > 0) mbar_wait(&empty[wg * WG_MAX_STAGES + slot], (round - 1) & 1);
        mbar_arrive_expect_tx(bar, (uint32_t)stage_bytes);
        bulk_g2s(my_ring + (size_t)slot * stage_bytes,
                 dYt + ((size_t)w.t * n_k + ki) * stage_bytes, (uint32_t)stage_bytes, bar);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(WG_CONSUMER_REGS));

  // ---- the consumers: warpgroup wg, its warp wq (rows 16 wq .. 16 wq + 15
  // of the tile), the fragment's group g and thread in group t4
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const bool vec = a.vec != 0;
  const uint32_t ring_u32 = smem_u32(ring) + (uint32_t)(wg * S * stage_bytes);
  uint64_t* my_full = full + wg * WG_MAX_STAGES;
  uint64_t* my_empty = empty + wg * WG_MAX_STAGES;

  float acc[32], tA[32], tB[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) tA[i] = tB[i] = 0.0f;
  // the next tile's M (raw words, in the accumulator's layout) and dq
  uint32_t mw[2][8][2];
  float dqv[8][2];

  // this thread's two rows of the panel, h = 0, 1: row 16 wq + 8 h + g
  const float* arow = As + (16 * wq + g) * a_words;
  const unsigned short* arow16 = reinterpret_cast<const unsigned short*>(arow);

  // start the loads of this consumer's tile at w: M and dq into registers
  auto prefetch = [&](const TileWalk& w) {
    const int c0 = (w.u / nsplit) * WG_CELLS, s0 = w.t * WG_SPOTS;
    const int cols = min(WG_SPOTS, s - s0);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int col = 8 * jn + 2 * t4;
      dqv[jn][0] = col < cols ? __ldg(a.dq + s0 + col) : 0.0f;
      dqv[jn][1] = col + 1 < cols ? __ldg(a.dq + s0 + col + 1) : 0.0f;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cell = c0 + 16 * wq + 8 * h + g;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int col = 8 * jn + 2 * t4;
        const int nv = cell < c ? max(0, min(2, cols - col)) : 0;
        load2(a.M, (size_t)cell * s + s0 + col, m_bf16, nv, vec, mw[h][jn]);
      }
    }
  };

  // the A fragments of chunk ki's 16-deep group grp (0 or 1), f32: hi, lo
  // of two k8 steps
  auto load_a = [&](int ki, int grp, uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
    const float4 v0 = *reinterpret_cast<const float4*>(arow + ki * WG_KC + 8 * t4 + 4 * grp);
    const float4 v1 =
        *reinterpret_cast<const float4*>(arow + 8 * a_words + ki * WG_KC + 8 * t4 + 4 * grp);
    // k8 step ks takes entries 2 ks (slot t4) and 2 ks + 1 (slot t4 + 4)
    split_tf32(v0.x, hi[0][0], lo[0][0]);
    split_tf32(v1.x, hi[0][1], lo[0][1]);
    split_tf32(v0.y, hi[0][2], lo[0][2]);
    split_tf32(v1.y, hi[0][3], lo[0][3]);
    split_tf32(v0.z, hi[1][0], lo[1][0]);
    split_tf32(v1.z, hi[1][1], lo[1][1]);
    split_tf32(v0.w, hi[1][2], lo[1][2]);
    split_tf32(v1.w, hi[1][3], lo[1][3]);
  };
  // the f32 wgmma group of chunk ki's 16-deep group grp into d, from
  // zero: lo*hi, hi*lo of both k8 steps, then hi*hi
  auto issue = [&](float (&d)[32], uint32_t slot_addr, int grp, const uint32_t (&hi)[2][4],
                   const uint32_t (&lo)[2][4]) {
    const uint32_t h0 = slot_addr + grp * 4096;  // k8 steps 2 grp, 2 grp + 1
    const uint32_t l0 = h0 + WG_SPOTS * WG_KC * 4;
    const uint64_t dh0 = wg_desc(h0), dh1 = wg_desc(h0 + 2048);
    const uint64_t dl0 = wg_desc(l0), dl1 = wg_desc(l0 + 2048);
    wgmma_tf32(d, lo[0], dh0, 0);
    wgmma_tf32(d, hi[0], dl0, 1);
    wgmma_tf32(d, lo[1], dh1, 1);
    wgmma_tf32(d, hi[1], dl1, 1);
    wgmma_tf32(d, hi[0], dh0, 1);
    wgmma_tf32(d, hi[1], dh1, 1);
  };
  auto release = [&](int fill) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&my_empty[fill % S]);
  };

  // this consumer's first tile, and the loads of its M
  TileWalk next = first;
  if (wg == 1) walk_next(next, u1, nsplit, per, n_tiles);
  if (next.u < u1) prefetch(next);

  int j = 0, group = -1;
  for (int u = u0; u < u1; ++u) {
    const int gi = u / nsplit, sp = u % nsplit;
    const int c0 = gi * WG_CELLS;
    if (gi != group) {
      // the next group's A panel: every consumer is done with the last one
      named_sync(WG_BAR_PANEL, WG_CONSUMER_THREADS);
      const int segs = Kp / 4;
      for (int e = tid; e < WG_CELLS * segs; e += WG_CONSUMER_THREADS) {
        const int row = e / segs, seg = e % segs;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (c0 + row < c)
          v = __ldg(reinterpret_cast<const float4*>(a.Aop + (size_t)(c0 + row) * Kp) + seg);
        if constexpr (SPLIT) {
          *reinterpret_cast<float4*>(As + row * a_words + seg * 4) = v;
        } else {
          // exact bf16 values: their upper halves
          uint2 p;
          p.x = (__float_as_uint(v.x) >> 16) | (__float_as_uint(v.y) & 0xFFFF0000u);
          p.y = (__float_as_uint(v.z) >> 16) | (__float_as_uint(v.w) & 0xFFFF0000u);
          *reinterpret_cast<uint2*>(reinterpret_cast<unsigned short*>(As) +
                                    (size_t)row * 2 * a_words + seg * 4) = p;
        }
      }
      named_sync(WG_BAR_PANEL, WG_CONSUMER_THREADS);
      group = gi;
    }
    // this thread's rows' constants: m, 1/l, log l, dh, w
    float rc[2][5];
    int cell[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      cell[h] = c0 + 16 * wq + 8 * h + g;
#pragma unroll
      for (int q = 0; q < 5; ++q) rc[h][q] = 0.0f;
      if (cell[h] < c) {
        const float lv = __ldg(a.l + cell[h]);
        rc[h][0] = __ldg(a.m + cell[h]);
        rc[h][1] = 1.0f / lv;
        rc[h][2] = logf(lv);
        if (WITH_DH) rc[h][3] = __ldg(a.dh + cell[h]);
        rc[h][4] = __ldg(a.w + cell[h]);
      }
    }
    // the (unit, warpgroup)'s per-cell sums
    float racc[2] = {0.0f, 0.0f};

    const int t_hi = min(sp * per + per, n_tiles);
    for (int t = sp * per; t < t_hi; ++t, ++j) {
      if ((j & 1) != wg) continue;
      // ---- the product: K in chunks of 32 from the ring
      const int n = j >> 1;  // this consumer's n-th tile
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      uint32_t hi0[2][4], lo0[2][4], hi1[2][4], lo1[2][4];
      if constexpr (SPLIT) {
        // a chunk's two 16-deep groups go into the fresh accumulators tA
        // and tB as one wgmma group, added to acc in K order once it is done
        for (int ki = 0; ki < n_k; ++ki) {
          const int fill = n * n_k + ki, slot = fill % S;
          mbar_wait(&my_full[slot], (fill / S) & 1);
          const uint32_t slot_addr = ring_u32 + slot * stage_bytes;
          load_a(ki, 0, hi0, lo0);
          load_a(ki, 1, hi1, lo1);
          wgmma_fence();
          issue(tA, slot_addr, 0, hi0, lo0);
          issue(tB, slot_addr, 1, hi1, lo1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(tA);
          fence_acc(tB);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] += tA[i];
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[i] += tB[i];
          release(fill);
        }
      } else {
        // exact bf16 products summed on the tensor cores, a chunk a wgmma
        // group, the next chunk's group issued before the last one's wait;
        // the chunks' A fragments alternate between hi0 and hi1
        auto chunk = [&](int ki, uint32_t (&frag)[2][4]) {
          const int fill = n * n_k + ki, slot = fill % S;
          mbar_wait(&my_full[slot], (fill / S) & 1);
          const uint32_t slot_addr = ring_u32 + slot * stage_bytes;
          // both 16-deep steps' fragments from one 16-byte load a row
          const uint4 v0 = *reinterpret_cast<const uint4*>(arow16 + ki * WG_KC + 8 * t4);
          const uint4 v1 =
              *reinterpret_cast<const uint4*>(arow16 + 16 * a_words + ki * WG_KC + 8 * t4);
          frag[0][0] = v0.x;
          frag[0][1] = v1.x;
          frag[0][2] = v0.y;
          frag[0][3] = v1.y;
          frag[1][0] = v0.z;
          frag[1][1] = v1.z;
          frag[1][2] = v0.w;
          frag[1][3] = v1.w;
          wgmma_fence();
          wgmma_bf16(acc, frag[0], wg_desc(slot_addr), 1);
          wgmma_bf16(acc, frag[1], wg_desc(slot_addr + 2048), 1);
          wgmma_commit();
          wgmma_wait<1>();  // the last chunk's group is done
          if (ki > 0) release(fill - 1);
        };
        int ki = 0;
        for (; ki + 1 < n_k; ki += 2) {
          chunk(ki, hi0);
          chunk(ki + 1, hi1);
        }
        if (ki < n_k) chunk(ki, hi0);
        wgmma_wait<0>();
        fence_acc(acc);
        release(n * n_k + n_k - 1);
      }
      // ---- the epilogue, in the accumulator's layout: acc[4 jn + 2 h + q]
      // is row 16 wq + 8 h + g, column 8 jn + 2 t4 + q of the tile; two
      // 8-spot steps a pass, after which the accumulators, dq and M's words
      // move down two steps (the header note)
      const int cols = min(WG_SPOTS, s - t * WG_SPOTS);
#pragma unroll 1
      for (int jb = 0; jb < 4; ++jb) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = 8 * (2 * jb + jj) + 2 * t4;
          const int nv = max(0, min(2, cols - col));
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (cell[h] >= c || nv <= 0) continue;
            float x[2];
            unpack2(mw[h][jj], m_bf16, x);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              if (q >= nv) continue;
              const float P = expf(x[q] - rc[h][0]) * rc[h][1];
              float dP = fmaf(rc[h][4], dqv[jj][q], acc[4 * jj + 2 * h + q]);
              if (WITH_DH) dP += rc[h][3] * ((x[q] - rc[h][0] - rc[h][2]) + 1.0f);
              racc[h] = fmaf(P, dP, racc[h]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 24; ++i) acc[i] = acc[i + 8];
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            dqv[i][q] = dqv[i + 2][q];
            mw[0][i][q] = mw[0][i + 2][q];
            mw[1][i][q] = mw[1][i + 2][q];
          }
      }
      // the loads of this consumer's next tile
      walk_next(next, u1, nsplit, per, n_tiles);
      walk_next(next, u1, nsplit, per, n_tiles);
      if (next.u < u1) prefetch(next);
    }

    // ---- the (unit, warpgroup)'s per-cell sums: over the quad's 4 lanes,
    // then once into row 2 sp + wg of the partials
    const size_t out_row = (size_t)(2 * sp + wg) * c;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      racc[h] = sum_reduce(racc[h], 4);
      if (t4 == 0 && cell[h] < c) a.row_part[out_row + cell[h]] = racc[h];
    }
  }
}

// dY (n, k) with rows ldx entries apart, f32 or bf16, into the stages the
// kernel copies: tile T (64 spots) and K chunk C (32) make stage T n_k + C;
// in it, logical K index L of spot nl sits in core matrix (L / 4, nl / 8)
// (f32; bf16: (L / 8, nl / 8)), 1,024 bytes apart along K and 128 along N,
// row nl % 8, and holds dY[spot][32 C + wg_perm(L)], 0 past n and k. split:
// the stage is hi then lo of tf32_split (ops/cuda_core.py), in f32; else the
// bf16 values.
__device__ __forceinline__ int wg_perm(int L, bool split) {
  const int kk = L >> 4;
  if (split) {
    const int ks = (L >> 3) & 1, jj = L & 7;
    return 8 * (jj & 3) + 4 * kk + 2 * ks + (jj >> 2);
  }
  const int kl = L & 15;
  return 8 * ((kl & 7) >> 1) + 4 * kk + 2 * (kl >> 3) + (kl & 1);
}

// tf32_split's rounding: to nearest on the 13 dropped bits, ties away from
// zero; truncated where rounding up would overflow
__device__ __forceinline__ float round_tf32_bits(float x) {
  const uint32_t bits = __float_as_uint(x);
  const uint32_t up = (bits + 0x1000u) & ~0x1FFFu;
  return __uint_as_float((up & 0x7F800000u) == 0x7F800000u ? bits & ~0x1FFFu : up);
}

__global__ void wg_operand_kernel(const void* __restrict__ X, void* __restrict__ out,
                                  int x_bf16, int n, int k, int ldx, int Kp, int split,
                                  size_t total) {
  const int n_k = Kp / WG_KC;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t stage = e / (WG_SPOTS * WG_KC);
    const int w = (int)(e % (WG_SPOTS * WG_KC));
    int L, nl;
    if (split) {
      L = (w >> 8) * 4 + (w & 3);
      nl = ((w >> 5) & 7) * 8 + ((w >> 2) & 7);
    } else {
      L = (w >> 9) * 8 + (w & 7);
      nl = ((w >> 6) & 7) * 8 + ((w >> 3) & 7);
    }
    const size_t spot = (stage / n_k) * WG_SPOTS + nl;
    const int col = (int)(stage % n_k) * WG_KC + wg_perm(L, split != 0);
    float v = 0.0f;
    if (spot < (size_t)n && col < k) {
      const size_t at = spot * ldx + col;
      v = x_bf16 ? bf16_bits_to_f32(static_cast<const unsigned short*>(X)[at])
                 : static_cast<const float*>(X)[at];
    }
    if (split) {
      const float hi = round_tf32_bits(v);
      float* o = static_cast<float*>(out) + stage * (2 * WG_SPOTS * WG_KC) + w;
      o[0] = hi;
      o[WG_SPOTS * WG_KC] = round_tf32_bits(__fsub_rn(v, hi));
    } else {
      static_cast<unsigned short*>(out)[e] = (unsigned short)(__float_as_uint(v) >> 16);
    }
  }
}

cudaError_t launch_wgmma(bool with_dh, bool split, WgArgs& a, int blocks, cudaStream_t st) {
  void (*kernel)(const WgArgs);
  kernel = with_dh ? (split ? dp_wgmma_kernel<true, true> : dp_wgmma_kernel<true, false>)
                   : (split ? dp_wgmma_kernel<false, true> : dp_wgmma_kernel<false, false>);
  const size_t fixed = WG_BAR_BYTES + (size_t)WG_CELLS * wg_a_words(a.Kp, split) * 4;
  const size_t two_stages = 2 * (size_t)wg_stage_bytes(split);
  if (fixed + 2 * two_stages > WG_SMEM_MAX) return cudaErrorInvalidValue;
  const int stages = (int)min((size_t)WG_MAX_STAGES, (WG_SMEM_MAX - fixed) / two_stages);
  a.stages = stages;
  const size_t smem = fixed + stages * two_stages;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  void* args[] = {&a};
  err = cudaLaunchKernel((const void*)kernel, dim3(blocks), dim3(WG_THREADS), args, smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes).
// ---------------------------------------------------------------------------

// X (n, k), rows ldx entries apart, f32 (x_bf16 == 0) or bf16 -> out:
// ceil(n / 64) (Kp / 32) stages of 16,384 bytes (split) or 4,096 (bf16)
extern "C" int tg_dp_wgmma_operand(const void* X, void* out, int x_bf16, int n, int k, int ldx,
                                   int Kp, int split, void* stream) {
  if (Kp <= 0 || Kp % WG_KC != 0 || k > Kp || (!split && !x_bf16))
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)((n + WG_SPOTS - 1) / WG_SPOTS) * WG_SPOTS * Kp;
  if (total == 0) return (int)cudaSuccess;
  const size_t want = (total + 255) / 256;
  const int blocks = (int)(want < 8192 ? want : 8192);
  wg_operand_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(X, out, x_bf16, n, k, ldx, Kp,
                                                              split, total);
  return (int)cudaGetLastError();
}

// As tg_rbar in dp_tensor_kernels.cu (r_part: (2 nsplit, c) scratch; r:
// (c,)), except: dYt: dY's stages from tg_dp_wgmma_operand at the same Kp
// (<= 256) and split; nsplit: the spot splits of each 64-cell group (units of
// ceil(ceil(s / 64) / nsplit) 64-spot tiles); blocks: the persistent grid;
// M takes no staging granule (it is read into registers). The partials have
// a row per (split, warpgroup).
extern "C" int tg_rbar_wgmma(const void* M, const float* Aop, const void* dYt, const float* w,
                             const float* dq, const float* dh, const float* m, const float* l,
                             float* r_part, float* r, int c, int s, int Kp, int with_dh,
                             int vec, int nsplit, int blocks, int m_bf16, int split,
                             void* stream) {
  const int n_tiles = (s + WG_SPOTS - 1) / WG_SPOTS;
  const int per = nsplit > 0 ? (n_tiles + nsplit - 1) / nsplit : 0;
  if (Kp <= 0 || Kp % WG_KC != 0 || Kp > WG_KMAX || nsplit <= 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  WgArgs a = {};
  a.M = M;
  a.Aop = Aop;
  a.dYt = dYt;
  a.w = w;
  a.dq = dq;
  a.dh = dh;
  a.m = m;
  a.l = l;
  a.row_part = r_part;
  a.c = c;
  a.s = s;
  a.Kp = Kp;
  a.vec = vec;
  a.nsplit = nsplit;
  a.tiles_per_split = per;
  a.m_bf16 = m_bf16;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = launch_wgmma(with_dh != 0, split != 0, a, blocks, st);
  if (err != cudaSuccess) return (int)err;
  dp_merge_kernel<false, false><<<(c + 255) / 256, 256, 0, st>>>(
      r_part, r, nullptr, nullptr, nullptr, nullptr, c, 2 * nsplit);
  return (int)cudaGetLastError();
}
