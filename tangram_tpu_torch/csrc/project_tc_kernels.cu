// The projection on the tensor cores (sm_90a).
//
//   tg_project  replaces tangram_tpu/ops/pallas_core.py::_project (kernel
//               _project_kernel): Y = P^T A (s, k) and q = w P (s,), with
//               P = exp(M - m) / l recomputed from the carried row stats and
//               never stored; M f32 or bf16, A f32 or bf16.
//
// The GEMM view. Y_ext[s, j] = sum_c P[c, s] X[c, j] with X = [A | w]
// (c x (k + 1)): spots are the product's rows, the columns of X its columns
// and the cells, 26,000 deep at the tutorial shape, its K axis, the one that
// crosses the softmax rows. Column k of the result is q.
//
// What bounds it on the H100. The contraction is 2 c s (k + 1) flops (1.28e11
// at 26,000 x 9,852 x 249): 1.91 ms on the f32 FMA pipes, 0.78 ms as three
// TF32 passes at the tensor cores' peak. M is read once (1.02 GB, 0.31 ms).
// With bf16 A and M the product is one exact bf16 pass and M's 0.51 GB bound
// it. The FMA kernel this replaces (an 8 x 8 register tile, 4 FMAs per
// shared-memory float) took 6.9 ms, held by its shared-memory loads.
//
// The design.
//  * f32 accuracy on the tensor cores (3xTF32). Every operand element is
//    split once, where it is formed in shared memory, into hi = tf32(x) and
//    lo = x - hi (split_tf32, Veltkamp's product on the FMA pipes), and the
//    tile sums lo*hi + hi*lo + hi*hi with f32 accumulation, the small terms
//    first. P is formed in the kernel, so its split costs three FMA-pipe
//    instructions beside its exp. X's chunk is split as it arrives, by every
//    block that reads it. The alternative, X split once per fit (or per step
//    in constrained mode, where A = S sigma(F) moves) into a hi and a lo
//    array: 53 MB resident instead of a per-call f32 copy of 26.6 MB (the
//    [A | w] rows padded to 16 bytes for the asynchronous copies, 0.02 ms of
//    HBM traffic), and every one of the 154 spot tiles would then stream
//    53 MB through L2 instead of 26.6: 8.2 GB per launch instead of 4.1.
//    The split in the kernel costs the forming warps a read and two writes
//    of each X entry in shared memory instead.
//  * The product is mma.sync.m16n8k8 (tf32) with operands loaded from the
//    split tiles, never split per fragment load (the lesson of
//    dp_tensor_kernels.cu: a split in the product loop cost more than the
//    tensor cores). wgmma was not built: see "Why not wgmma" below.
//  * The truncation trap. Every term P X is >= 0 (P >= 0, counts >= 0,
//    w > 0), so the tensor cores' truncation of a running sum is a one-sided
//    bias that grows with depth: one accumulator over all 26,000 cells would
//    lose about 26,000 / 8 / 4 f32 ulps of each sum. Each chunk of 16 cells
//    (6 mma: two k8 steps of three terms) goes into fresh accumulators, the
//    first product onto zero, and is added to the tile's sum by a rounded
//    f32 add, as the dP tile does: the truncations act on partial sums of
//    16 terms. chip_smoke.py's f32 witness holds Y and q to that at the
//    tutorial depth.
//  * bf16 A (the compute_dtype option): JAX rounds P to bf16 for Y and keeps
//    the f32 P for q. Here P is rounded once where it is formed, pairs of
//    cells packed into 32-bit words (the layout of an m16n8k16 fragment), X
//    packed the same way, and Y takes one exact bf16 pass per chunk
//    (mma.sync.m16n8k16, f32 accumulation, the same fresh accumulator per
//    chunk); q = w P is summed from the f32 P by FMA where P is formed, and
//    merged across the forming threads in a fixed order.
//  * Two roles (warp specialization). Two warpgroups copy and form: the raw
//    M chunk (16 cells x 64 spots, in M's type), X's chunk (16 cells x 256
//    columns) and the chunk's m, l (and w) arrive by cp.async into a ring of
//    four stages, three chunks ahead; the forming threads turn each into P
//    and X's split in one of three formed buffers. The other two warpgroups
//    (8 warps) run the product from the formed buffers. Named barriers hand
//    each buffer over (FULL) and back (EMPTY), so forming, copying and the
//    tensor cores overlap. setmaxnreg moves registers from the forming
//    warps (56 a thread) to the product warps (200: 64 accumulators, both
//    parts of two k8 steps of fragments, and the fresh accumulators). The
//    forming takes two warpgroups: its exp, split and shared-memory traffic
//    is latency-bound per warp.
//  * Layouts. M's rows take 16, 8 or 4 bytes a copy, whichever divides the
//    row length and the base (a bf16 row of 9,852 entries is 19,704 bytes:
//    8), or go entry by entry through registers (a bf16 M with an odd row);
//    X's rows are 16-byte aligned by the wrapper. Formed tiles keep the
//    cells as rows (P[cell][spot], X[cell][column]), as the chunks arrive:
//    no transpose. Fragment loads are conflict-free 16- and 8-byte loads
//    from rows padded by 8 words, with the fragment rows mapped to spots
//    4g .. 4g + 3 and the fragment columns to column pairs, so that one load
//    fills several fragment registers; the epilogue undoes the mapping.
//  * The block: product warps as 2 (spots) x 4 (columns), a warp tile of 32
//    spots x 64 columns (16 m16n8 tiles), a block tile of 64 spots x 256
//    columns, so at k + 1 <= 256 every P entry is formed once; k + 1 > 256
//    walks column panels (grid.y), each forming P again. Shared memory: the
//    ring 81 KB + three formed buffers 126 KB = 207 KB, one block of 512
//    threads per SM.
//  * Cross-block sums stay deterministic: the cells are cut into nsplit
//    contiguous ranges (grid.z), each block writes its own partial, and
//    ext_reduce_kernel (common.cuh) adds them in split order. No atomics.
//  * Ragged edges: cells >= c (past the split's range) and spots >= s give
//    P = 0; a PAD sentinel in M gives exp -> 0; X's rows past the range and
//    its columns past the operand are zero-filled by the copies.
//
// What holds it back (chip_smoke.py --profile times each side alone, and
// PERF.md keeps the numbers): the product side alone takes most of the
// kernel's time in f32, the rate of mma.sync tf32 on this card being far
// below the tensor cores' TF32 peak, which only wgmma reaches; in bf16 the
// forming side (P's exp and the packing) takes most of it.
//
// Why not wgmma. A tf32 wgmma keeps a warpgroup's 64 x N accumulator in its
// registers for the whole tile; the fresh accumulator of every 16 cells
// doubles that (N = 256: 256 registers a thread), so N <= 128 and the 256
// columns need two warpgroups per 64 spots. Its operands would go K-major
// (cells contiguous), which needs a transpose of both raw chunks where they
// are formed, and shared-memory descriptors of a swizzled layout. It stays
// open (ROADMAP queue B).
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing and returns the cudaError_t of its launches.

#include "common.cuh"

namespace {

constexpr int PJ_TS = 64;        // spots per block
constexpr int PJ_TN = 256;       // columns of [A | w] per block
constexpr int PJ_KC = 16;        // cells per chunk: one fresh accumulator
constexpr int PJ_MMA_THREADS = 256;  // 8 product warps: 2 (spots) x 4 (columns)
constexpr int PJ_FORM_THREADS = 256; // two warpgroups: copies and forming
constexpr int PJ_THREADS = PJ_MMA_THREADS + PJ_FORM_THREADS;
// registers a thread: at launch (the launch bounds give each of the 512
// threads 65,536 / 512, rounded down to 8), and after setmaxnreg, which
// moves registers between the warpgroups of a block: the forming
// warpgroups release what the product warps' accumulators and fragments
// take (setmaxnreg.inc waits until the block's released registers cover it)
constexpr int PJ_LAUNCH_REGS = 65536 / PJ_THREADS / 8 * 8;
constexpr int PJ_MMA_REGS = 200, PJ_FORM_REGS = 56;
static_assert(PJ_MMA_THREADS * (PJ_MMA_REGS - PJ_LAUNCH_REGS) <=
                  PJ_FORM_THREADS * (PJ_LAUNCH_REGS - PJ_FORM_REGS),
              "the product warps take only what the forming warpgroups release");
constexpr int PJ_STAGES = 4;     // the raw ring
constexpr int PJ_NBUF = 3;       // formed buffers
constexpr int PJ_PLD = PJ_TS + 8;  // formed P tile row stride, words
constexpr int PJ_XLD = PJ_TN + 8;  // formed X tile row stride, words
// bytes: one ring stage holds a raw M chunk and a raw X chunk (f32 sizes;
// bf16 uses the first half of each) and the chunk's m, l and w
constexpr int PJ_RAW_M = PJ_KC * PJ_TS * 4;
constexpr int PJ_RAW_X = PJ_KC * PJ_TN * 4;
constexpr int PJ_ROWC = 3 * PJ_KC * 4;
constexpr int PJ_STAGE = PJ_RAW_M + PJ_RAW_X + PJ_ROWC;
// one formed buffer: P hi, P lo, X hi, X lo (a bf16 A uses the first rows
// of P hi and X hi for its packed pairs)
constexpr int PJ_PT = PJ_KC * PJ_PLD * 4;
constexpr int PJ_XT = PJ_KC * PJ_XLD * 4;
constexpr int PJ_BUF = 2 * (PJ_PT + PJ_XT);
constexpr int PJ_SMEM = PJ_STAGES * PJ_STAGE + PJ_NBUF * PJ_BUF;
// named barriers: 0 is __syncthreads; FULL + b and EMPTY + b hand formed
// buffer b between the roles; FORM syncs the forming warpgroups
constexpr int PJ_BAR_FULL = 1, PJ_BAR_EMPTY = PJ_BAR_FULL + PJ_NBUF;
constexpr int PJ_BAR_FORM = PJ_BAR_EMPTY + PJ_NBUF;
static_assert(PJ_BAR_FORM < 16, "16 named barriers");

// Built with -DTG_DP_PROFILE (chip_smoke.py --profile), product warp 0 and
// forming warp 8 of every block add the clock cycles of each phase of their
// chunk loops to tg_pj_clocks (product warp: 0 the epilogue and the loop's
// bookkeeping, 1 waiting for a formed buffer, 4 the product; forming warp:
// 5 + 0 bookkeeping, 5 + 1 waiting for copies, a free buffer and the other
// forming warps, 5 + 2 issuing the copies, 5 + 3 forming P and X).
// tg_pj_profile_read returns and clears them. Two more builds time each
// side alone, their results meaningless: -DTG_PJ_FORM_ONLY skips the
// product, -DTG_PJ_PRODUCT_ONLY the copies and the forming (the product
// then runs on whatever the buffers hold).
#ifdef TG_DP_PROFILE
__device__ unsigned long long tg_pj_clocks[10];
#define TG_PJ_MARK(i)                    \
  {                                      \
    const long long now_ = clock64();    \
    phase_clocks[i] += now_ - last_mark; \
    last_mark = now_;                    \
  }
#else
#define TG_PJ_MARK(i)
#endif

struct PjArgs {
  const void* M;      // (c, s) f32 or bf16
  const void* X;      // (c, ldx): [A | w | 0] f32, or [A | 0] bf16 (a bf16 A)
  const float* w;     // (c,): q's weights with a bf16 A; 16-byte aligned
  const float* m;     // (c,) row max; 16-byte aligned
  const float* l;     // (c,) row sum of exp; 16-byte aligned
  float* partial;     // (nsplit, s, k + 1)
  int c, s, k, ldx, cells_per_split;
  int cp_m;           // bytes per copy of M's rows: 16, 8, 4; 0 by entry (bf16)
};

// the copy of `bytes` (4, 8 or 16) bytes, of which the first n (0..bytes)
// come from gmem and the rest read zero
__device__ __forceinline__ void cp_async_n(void* smem, const void* gmem, int bytes, int n) {
  if (bytes == 16) cp_async_part<16>(smem, gmem, n);
  else if (bytes == 8) cp_async_part<8>(smem, gmem, n);
  else cp_async_part<4>(smem, gmem, n);
}

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// named barrier `id` over `n` threads: wait for all, or arrive only
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <typename TM, bool A_BF16>
__global__ void __launch_bounds__(PJ_THREADS, 1) project_tc_kernel(const PjArgs a) {
  constexpr int ESZ_M = sizeof(TM);
  constexpr int ESZ_X = A_BF16 ? 2 : 4;
  extern __shared__ __align__(16) char smem[];
  char* const ring = smem;
  char* const formed = smem + PJ_STAGES * PJ_STAGE;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int s = a.s, k = a.k, K1 = k + 1;
  const int s0 = blockIdx.x * PJ_TS;
  const int j0 = blockIdx.y * PJ_TN;
  const int c_begin = blockIdx.z * a.cells_per_split;
  const int c_end = min(a.c, c_begin + a.cells_per_split);
  const int n_chunks = c_end > c_begin ? (c_end - c_begin + PJ_KC - 1) / PJ_KC : 0;
  const int cols_m = min(PJ_TS, s - s0);  // valid spots of this tile
  float* out = a.partial + (size_t)blockIdx.z * s * K1;
#ifdef TG_DP_PROFILE
  long long phase_clocks[5] = {0, 0, 0, 0, 0};
  long long last_mark = clock64();
#endif

  if (tid >= PJ_MMA_THREADS) {
    // ================= the forming warpgroups: copies, P, X's split ========
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PJ_FORM_REGS));
    const int ft = tid - PJ_MMA_THREADS;
    const int ldx = a.ldx, cp_m = a.cp_m;
    // M's copies per row, a power of two: 64 entries of ESZ_M bytes over cp_m
    const int segs_lg = cp_m ? __ffs(PJ_TS * ESZ_M / cp_m) - 1 : 0;
    const char* const Mb = static_cast<const char*>(a.M);
    const char* const Xb = static_cast<const char*>(a.X);
    // copies of one chunk (cells c0 .. c0 + 15) into a ring stage
    auto issue_chunk = [&](int c0, char* stage) {
      // M: 16 rows of the tile's 64 spots; rows past c_end and spots past s
      // read zero (P masks them anyway)
      if (cp_m == 0) {
        // a bf16 M with an odd row: entry by entry through registers
        const unsigned short* src = static_cast<const unsigned short*>(a.M);
        unsigned short* d16 = reinterpret_cast<unsigned short*>(stage);
#pragma unroll
        for (int q = 0; q < PJ_KC * PJ_TS / PJ_FORM_THREADS; ++q) {
          const int e = ft + q * PJ_FORM_THREADS;
          const int row = e >> 6, col = e & (PJ_TS - 1);
          const int cell = c0 + row;
          d16[e] = cell < c_end && col < cols_m ? src[(size_t)cell * s + s0 + col] : 0;
        }
      } else {
        const int segs = 1 << segs_lg;
        const int row_bytes = cols_m * ESZ_M;
        for (int e = ft; e < (PJ_KC << segs_lg); e += PJ_FORM_THREADS) {
          const int row = e >> segs_lg, off = (e & (segs - 1)) * cp_m;
          const int cell = c0 + row;
          const int n = cell < c_end ? max(0, min(cp_m, row_bytes - off)) : 0;
          const char* src = n ? Mb + ((size_t)cell * s + s0) * ESZ_M + off : Mb;
          cp_async_n(stage + row * (PJ_TS * ESZ_M) + off, src, cp_m, n);
        }
      }
      // the chunk's m, l and w (w with a bf16 A only), 16 bytes a copy
      if (ft < (A_BF16 ? 12 : 8)) {
        const int v = ft >> 2, seg = (ft & 3) * 4;
        const float* src = (v == 0 ? a.m : v == 1 ? a.l : a.w) + c0 + seg;
        const int n = max(0, min(4, c_end - c0 - seg)) * 4;
        cp_async_part<16>(stage + PJ_RAW_M + PJ_RAW_X + (v * PJ_KC + seg) * 4,
                          n ? src : a.m, n);
      }
      // X: 16 rows of 256 columns from j0, 16 bytes a copy; rows past c_end
      // and columns past ldx read zero
      char* dst_x = stage + PJ_RAW_M;
      constexpr int XSEG = 16 / ESZ_X;         // entries per copy
      constexpr int XSEGS = PJ_TN / XSEG;      // copies per row
      constexpr int XSEG_LG = A_BF16 ? 5 : 6;  // log2(XSEGS)
      static_assert(PJ_KC * XSEGS % PJ_FORM_THREADS == 0, "whole X copies per thread");
#pragma unroll
      for (int q = 0; q < PJ_KC * XSEGS / PJ_FORM_THREADS; ++q) {
        const int e = ft + q * PJ_FORM_THREADS;
        const int row = e >> XSEG_LG, col = (e & (XSEGS - 1)) * XSEG;
        const int cell = c0 + row;
        const bool ok = cell < c_end && j0 + col < ldx;
        cp_async_16(dst_x + (row * PJ_TN + col) * ESZ_X,
                    ok ? Xb + ((size_t)cell * ldx + j0 + col) * ESZ_X : Xb, ok);
      }
    };

    // forming one chunk from its ring stage into a buffer: P = exp(M - m)/l
    // (0 outside the valid cells and spots), split into TF32 hi/lo (f32 A)
    // or rounded to bf16 and packed by cell pairs (bf16 A, with q's sums
    // from the f32 P); X split (f32) or packed by cell pairs (bf16)
    float qacc[2] = {0.0f, 0.0f};  // bf16 A: q of spots 2 (ft & 31) + 0, 1
    auto form_chunk = [&](int c0, const char* stage, char* buf) {
      float* Ph = reinterpret_cast<float*>(buf);
      float* Pl = Ph + PJ_KC * PJ_PLD;
      float* Xh = Pl + PJ_KC * PJ_PLD;
      float* Xl = Xh + PJ_KC * PJ_XLD;
      const char* raw_m = stage;
      const char* raw_x = stage + PJ_RAW_M;
      const float* rowc = reinterpret_cast<const float*>(stage + PJ_RAW_M + PJ_RAW_X);
      if constexpr (!A_BF16) {
#pragma unroll
        for (int h = 0; h < PJ_KC * PJ_TS / 4 / PJ_FORM_THREADS; ++h) {  // P: 2 x 4
          const int row = (ft >> 4) + h * (PJ_FORM_THREADS / 16), col = (ft & 15) * 4;
          const int cell = c0 + row;
          float x[4];
          if constexpr (ESZ_M == 4) {
            const float4 v = *reinterpret_cast<const float4*>(raw_m + (row * PJ_TS + col) * 4);
            x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
          } else {
            const uint2 v = *reinterpret_cast<const uint2*>(raw_m + (row * PJ_TS + col) * 2);
            x[0] = __uint_as_float(v.x << 16);
            x[1] = __uint_as_float(v.x & 0xFFFF0000u);
            x[2] = __uint_as_float(v.y << 16);
            x[3] = __uint_as_float(v.y & 0xFFFF0000u);
          }
          const bool cv = cell < c_end;
          const float mc = cv ? rowc[row] : 0.0f;
          const float il = cv ? 1.0f / rowc[PJ_KC + row] : 0.0f;
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = cv && col + e < cols_m ? expf(x[e] - mc) * il : 0.0f;
            split_tf32(p, hi[e], lo[e]);
          }
          *reinterpret_cast<uint4*>(Ph + row * PJ_PLD + col) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(Pl + row * PJ_PLD + col) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
#pragma unroll 4
        for (int q = 0; q < PJ_KC * PJ_TN / 4 / PJ_FORM_THREADS; ++q) {  // X: 8 x 4
          const int e = ft + q * PJ_FORM_THREADS;
          const int row = e >> 6, col = (e & 63) * 4;
          const float4 v = *reinterpret_cast<const float4*>(raw_x + (row * PJ_TN + col) * 4);
          uint32_t hi[4], lo[4];
          split_tf32(v.x, hi[0], lo[0]);
          split_tf32(v.y, hi[1], lo[1]);
          split_tf32(v.z, hi[2], lo[2]);
          split_tf32(v.w, hi[3], lo[3]);
          *reinterpret_cast<uint4*>(Xh + row * PJ_XLD + col) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(Xl + row * PJ_XLD + col) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
      } else {
        uint32_t* Pb = reinterpret_cast<uint32_t*>(Ph);  // [8 cell pairs][PJ_PLD]
        uint32_t* Xp = reinterpret_cast<uint32_t*>(Xh);  // [8 cell pairs][PJ_XLD]
        const int col = (ft & 31) * 2;
#pragma unroll
        for (int hp = 0; hp < PJ_KC / 2 * PJ_TS / 2 / PJ_FORM_THREADS; ++hp) {  // P: 2 x 2 x 2
          const int rp = (ft >> 5) + hp * (PJ_FORM_THREADS / 32);
          float p[2][2];  // [cell of the pair][spot]
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 2 * rp + h, cell = c0 + row;
            float x[2];
            if constexpr (ESZ_M == 4) {
              const float2 v = *reinterpret_cast<const float2*>(raw_m + (row * PJ_TS + col) * 4);
              x[0] = v.x; x[1] = v.y;
            } else {
              const uint32_t v =
                  *reinterpret_cast<const uint32_t*>(raw_m + (row * PJ_TS + col) * 2);
              x[0] = __uint_as_float(v << 16);
              x[1] = __uint_as_float(v & 0xFFFF0000u);
            }
            const bool cv = cell < c_end;
            const float mc = cv ? rowc[row] : 0.0f;
            const float il = cv ? 1.0f / rowc[PJ_KC + row] : 0.0f;
            const float wc = cv ? rowc[2 * PJ_KC + row] : 0.0f;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              p[h][e] = cv && col + e < cols_m ? expf(x[e] - mc) * il : 0.0f;
              qacc[e] = fmaf(wc, p[h][e], qacc[e]);
            }
          }
          *reinterpret_cast<uint2*>(Pb + rp * PJ_PLD + col) =
              make_uint2(bf16_bits(p[0][0]) | bf16_bits(p[1][0]) << 16,
                         bf16_bits(p[0][1]) | bf16_bits(p[1][1]) << 16);
        }
#pragma unroll
        for (int q = 0; q < PJ_KC / 2 * PJ_TN / 4 / PJ_FORM_THREADS; ++q) {  // X: 4 x 4 pairs
          const int e = ft + q * PJ_FORM_THREADS;
          const int rp = e >> 6, xc = (e & 63) * 4;
          const uint2 v0 = *reinterpret_cast<const uint2*>(raw_x + ((2 * rp) * PJ_TN + xc) * 2);
          const uint2 v1 =
              *reinterpret_cast<const uint2*>(raw_x + ((2 * rp + 1) * PJ_TN + xc) * 2);
          *reinterpret_cast<uint4*>(Xp + rp * PJ_XLD + xc) =
              make_uint4(__byte_perm(v0.x, v1.x, 0x5410), __byte_perm(v0.x, v1.x, 0x7632),
                         __byte_perm(v0.y, v1.y, 0x5410), __byte_perm(v0.y, v1.y, 0x7632));
        }
      }
    };

    // the copies run PJ_STAGES chunks ahead; chunk t goes to buffer t % NBUF
    // once the product warps have released it (from chunk NBUF on)
    int is_c0 = c_begin, is_slot = 0, n_issued = 0;
    auto issue = [&]() {
#ifndef TG_PJ_PRODUCT_ONLY
      if (n_issued < n_chunks) issue_chunk(is_c0, ring + is_slot * PJ_STAGE);
#endif
      cp_async_commit();  // possibly empty: the group count stays uniform
      ++n_issued;
      is_c0 += PJ_KC;
      if (++is_slot == PJ_STAGES) is_slot = 0;
    };
#pragma unroll 1
    for (int st = 0; st < PJ_STAGES; ++st) issue();
    int c0 = c_begin, slot = 0, b = 0;
#pragma unroll 1
    for (int t = 0; t < n_chunks; ++t) {
      TG_PJ_MARK(0)
      cp_async_wait<PJ_STAGES - 1>();  // chunk t has landed
      bar_sync(PJ_BAR_FORM, PJ_FORM_THREADS);  // for every forming thread
      if (t >= PJ_NBUF) bar_sync(PJ_BAR_EMPTY + b, PJ_THREADS);
      TG_PJ_MARK(1)
#ifndef TG_PJ_PRODUCT_ONLY
      form_chunk(c0, ring + slot * PJ_STAGE, formed + b * PJ_BUF);
#endif
      TG_PJ_MARK(3)
      __threadfence_block();
      bar_arrive(PJ_BAR_FULL + b, PJ_THREADS);
      bar_sync(PJ_BAR_FORM, PJ_FORM_THREADS);  // every thread has read the stage
      TG_PJ_MARK(1)
      issue();  // chunk t + PJ_STAGES into the stage of chunk t
      TG_PJ_MARK(2)
      c0 += PJ_KC;
      if (++slot == PJ_STAGES) slot = 0;
      if (++b == PJ_NBUF) b = 0;
    }
    // match the product warps' releases of the last buffers
#pragma unroll 1
    for (int t = max(n_chunks, PJ_NBUF); t < n_chunks + PJ_NBUF; ++t)
      bar_sync(PJ_BAR_EMPTY + t % PJ_NBUF, PJ_THREADS);
    if constexpr (A_BF16) {
      cp_async_wait<0>();
      if (j0 <= k && k < j0 + PJ_TN) {
        // q: the 4 sums of each spot (cell pairs ft >> 5 and + 4, ...), added
        // in order
        bar_sync(PJ_BAR_FORM, PJ_FORM_THREADS);  // the ring is free
        float* red = reinterpret_cast<float*>(ring);  // [4][PJ_TS]
        const int col = (ft & 31) * 2;
        red[(ft >> 5) * PJ_TS + col] = qacc[0];
        red[(ft >> 5) * PJ_TS + col + 1] = qacc[1];
        bar_sync(PJ_BAR_FORM, PJ_FORM_THREADS);
        if (ft < PJ_TS && s0 + ft < s) {
          float v = 0.0f;
#pragma unroll
          for (int r = 0; r < PJ_FORM_THREADS / 32; ++r) v += red[r * PJ_TS + ft];
          out[(size_t)(s0 + ft) * K1 + k] = v;
        }
      }
    }
    TG_PJ_MARK(0)
#ifdef TG_DP_PROFILE
    if (lane == 0 && warp == PJ_MMA_THREADS / 32)
      for (int q = 0; q < 4; ++q)
        atomicAdd(&tg_pj_clocks[5 + q], (unsigned long long)phase_clocks[q]);
#endif
    return;
  }

  // ================= the product warps ======================================
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(PJ_MMA_REGS));
  const int g = lane >> 2, t4 = lane & 3;  // the fragment's group and thread in group
  const int wm = warp & 1;                 // 2 spot halves of 32
  const int wn = warp >> 1;                // 4 column quarters of 64

  // acc[i][j][q] is the m16n8 tile (i, j) of the warp: fragment row g
  // (g + 8) is spot wm*32 + 4g + 2i (+ 1), fragment column n is column
  // wn*64 + 16 (j >> 1) + 2n + (j & 1); so one 16-byte load gives a thread
  // its A entries of both m tiles, one 8-byte load its B entries of two n
  // tiles. Rows of the formed tiles are cells (TF32) or cell pairs (bf16).
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  auto product = [&](const char* buf) {
    const float* Ph = reinterpret_cast<const float*>(buf);
    const float* Pl = Ph + PJ_KC * PJ_PLD;
    const float* Xh = Pl + PJ_KC * PJ_PLD;
    const float* Xl = Xh + PJ_KC * PJ_XLD;
    const float* pa_h = Ph + wm * 32 + 4 * g;
    const float* pa_l = Pl + wm * 32 + 4 * g;
    const float* pb_h = Xh + wn * 64 + 2 * g;
    const float* pb_l = Xl + wn * 64 + 2 * g;
    if constexpr (!A_BF16) {
      // A fragments of both k8 steps: [ks][i][reg], reg = 2 slot + (row g + 8)
      uint32_t ahi[2][2][4], alo[2][2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
#pragma unroll
        for (int slot = 0; slot < 2; ++slot) {
          const int row = ks * 8 + t4 + 4 * slot;
          const uint4 h = *reinterpret_cast<const uint4*>(pa_h + row * PJ_PLD);
          const uint4 l = *reinterpret_cast<const uint4*>(pa_l + row * PJ_PLD);
          ahi[ks][0][2 * slot] = h.x; ahi[ks][0][2 * slot + 1] = h.y;
          ahi[ks][1][2 * slot] = h.z; ahi[ks][1][2 * slot + 1] = h.w;
          alo[ks][0][2 * slot] = l.x; alo[ks][0][2 * slot + 1] = l.y;
          alo[ks][1][2 * slot] = l.z; alo[ks][1][2 * slot + 1] = l.w;
        }
      // two column pairs (4 n tiles, 8 m16n8 tiles) at a time
#pragma unroll
      for (int pg = 0; pg < 4; pg += 2) {
        uint32_t bhi[2][2][2][2], blo[2][2][2][2];  // [pair][ks][n tile e][slot]
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int slot = 0; slot < 2; ++slot) {
              const int at = (ks * 8 + t4 + 4 * slot) * PJ_XLD + 16 * (pg + pp);
              const uint2 h = *reinterpret_cast<const uint2*>(pb_h + at);
              const uint2 l = *reinterpret_cast<const uint2*>(pb_l + at);
              bhi[pp][ks][0][slot] = h.x; bhi[pp][ks][1][slot] = h.y;
              blo[pp][ks][0][slot] = l.x; blo[pp][ks][1][slot] = l.y;
            }
        float tmp[2][2][2][4];  // [i][pair][e][q]
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int pp = 0; pp < 2; ++pp)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              mma_tf32_first(tmp[i][pp][e], alo[0][i], bhi[pp][0][e]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int pp = 0; pp < 2; ++pp)
#pragma unroll
            for (int e = 0; e < 2; ++e) mma_tf32(tmp[i][pp][e], ahi[0][i], blo[pp][0][e]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int pp = 0; pp < 2; ++pp)
#pragma unroll
            for (int e = 0; e < 2; ++e) mma_tf32(tmp[i][pp][e], alo[1][i], bhi[pp][1][e]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int pp = 0; pp < 2; ++pp)
#pragma unroll
            for (int e = 0; e < 2; ++e) mma_tf32(tmp[i][pp][e], ahi[1][i], blo[pp][1][e]);
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int pp = 0; pp < 2; ++pp)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                mma_tf32(tmp[i][pp][e], ahi[ks][i], bhi[pp][ks][e]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int pp = 0; pp < 2; ++pp)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                acc[i][2 * (pg + pp) + e][q] += tmp[i][pp][e][q];
      }
    } else {
      // one k16 step: rows are the 8 cell pairs, the fragment layout of
      // m16n8k16 in 32-bit words is that of m16n8k8 tf32 above
      uint32_t ab[2][4];
#pragma unroll
      for (int slot = 0; slot < 2; ++slot) {
        const uint4 h = *reinterpret_cast<const uint4*>(pa_h + (t4 + 4 * slot) * PJ_PLD);
        ab[0][2 * slot] = h.x; ab[0][2 * slot + 1] = h.y;
        ab[1][2 * slot] = h.z; ab[1][2 * slot + 1] = h.w;
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t bb[2][2];  // [n tile e][slot]
#pragma unroll
        for (int slot = 0; slot < 2; ++slot) {
          const uint2 h = *reinterpret_cast<const uint2*>(
              pb_h + (t4 + 4 * slot) * PJ_XLD + 16 * p);
          bb[0][slot] = h.x;
          bb[1][slot] = h.y;
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float tmp[4];
            mma_bf16_first(tmp, ab[i], bb[e]);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][2 * p + e][q] += tmp[q];
          }
      }
    }
  };

  int b = 0;
#pragma unroll 1
  for (int t = 0; t < n_chunks; ++t) {
    TG_PJ_MARK(0)
    bar_sync(PJ_BAR_FULL + b, PJ_THREADS);  // chunk t is formed in buffer b
    TG_PJ_MARK(1)
#ifndef TG_PJ_FORM_ONLY
    product(formed + b * PJ_BUF);
#endif
    TG_PJ_MARK(4)
    bar_arrive(PJ_BAR_EMPTY + b, PJ_THREADS);  // and may be overwritten
    if (++b == PJ_NBUF) b = 0;
  }

  // ---- the epilogue: this block's partial sums
  const int n_cols = A_BF16 ? k : K1;  // with a bf16 A, column k (q) comes from above
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int spot = s0 + wm * 32 + 4 * g + 2 * i + (q >> 1);
        const int col = j0 + wn * 64 + 16 * (j >> 1) + 4 * t4 + (j & 1) + 2 * (q & 1);
        if (spot < s && col < n_cols) out[(size_t)spot * K1 + col] = acc[i][j][q];
      }
#ifdef TG_DP_PROFILE
  TG_PJ_MARK(0)
  if (lane == 0 && warp == 0)
    for (int q = 0; q < 5; ++q) atomicAdd(&tg_pj_clocks[q], (unsigned long long)phase_clocks[q]);
#endif
}

template <typename TM, bool A_BF16>
cudaError_t launch_project(const PjArgs& a, dim3 grid, cudaStream_t st) {
  void (*kernel)(const PjArgs) = project_tc_kernel<TM, A_BF16>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         PJ_SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<PjArgs*>(&a)};
  err = cudaLaunchKernel((const void*)kernel, grid, dim3(PJ_THREADS), args, PJ_SMEM, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (loaded with ctypes).
//
// M: (c, s) f32 or bf16 (m_bf16); X: (c, ldx), row-major, 16-byte aligned:
// [A | w] f32 with columns k + 1 .. ldx - 1 zero and ldx a multiple of 4,
// or (a_bf16) A in bf16 with columns k .. ldx - 1 zero and ldx a multiple
// of 8; w: (c,) f32 (read with a bf16 A only); m, l: (c,); w, m and l
// 16-byte aligned; partial:
// (nsplit, s, k + 1) scratch; Y: (s, k); q: (s,); cp_m: the bytes per
// asynchronous copy of M's rows, 16, 8 or 4, dividing the row length in
// bytes and M's base address, or 0 (a bf16 M only) entry by entry.
// ---------------------------------------------------------------------------

extern "C" int tg_project(const void* M, const void* X, const float* w, const float* m,
                          const float* l, float* partial, float* Y, float* q, int c, int s,
                          int k, int ldx, int nsplit, int m_bf16, int a_bf16, int cp_m,
                          void* stream) {
  const bool cp_ok = cp_m == 16 || cp_m == 8 || cp_m == 4 || (cp_m == 0 && m_bf16);
  if (!cp_ok || nsplit <= 0 || ldx % (a_bf16 ? 8 : 4) != 0 || ldx < (a_bf16 ? k : k + 1))
    return (int)cudaErrorInvalidValue;
  PjArgs a = {};
  a.M = M;
  a.X = X;
  a.w = w;
  a.m = m;
  a.l = l;
  a.partial = partial;
  a.c = c;
  a.s = s;
  a.k = k;
  a.ldx = ldx;
  a.cp_m = cp_m;
  int per = (c + nsplit - 1) / nsplit;
  a.cells_per_split = (per + PJ_KC - 1) / PJ_KC * PJ_KC;
  const dim3 grid((s + PJ_TS - 1) / PJ_TS, (k + 1 + PJ_TN - 1) / PJ_TN, nsplit);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (m_bf16 && a_bf16) err = launch_project<bf16, true>(a, grid, st);
  else if (m_bf16) err = launch_project<bf16, false>(a, grid, st);
  else if (a_bf16) err = launch_project<float, true>(a, grid, st);
  else err = launch_project<float, false>(a, grid, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_ext_reduce(partial, Y, q, s, k, nsplit, st);
}

#ifdef TG_DP_PROFILE
// out[10]: the phase clocks summed since the last call (synchronises)
extern "C" int tg_pj_profile_read(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(out, tg_pj_clocks, sizeof(tg_pj_clocks));
  const unsigned long long zero[10] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(tg_pj_clocks, zero, sizeof(zero));
  return (int)err;
}
#endif
