// numpy's legacy normal stream on the card, bit for bit.
//
//   tg_normal_pass_a   the stream's checkpoints, each segment's accepted
//                      count and their exclusive prefix
//   tg_normal_pass_b   each segment's normals, written in place into M
//
// The seeded start of the mapper is the reference's stream: after
// np.random.seed(seed), np.random.normal(0, 1, (cells, spots)) in f64, cast
// to f32 (and to bf16 where M is stored so). It replaces no TPU kernel: the
// JAX package draws that stream on the host. NumPy's legacy RandomState
// draws each pair of normals by Marsaglia's polar method from MT19937:
//
//   d = ((w0 >> 5) * 2^26 + (w1 >> 6)) / 2^53  from two tempered words,
//   x1 = 2 d1 - 1, x2 = 2 d2 - 1, r2 = x1^2 + x2^2  (four words an attempt),
//   accepted iff r2 < 1 and r2 != 0; then f = sqrt(-2 log(r2) / r2) and the
//   outputs f x2, then f x1 (the second kept as the cached Gaussian).
//
// Attempts are independent of each other, and only the order of the
// accepted ones decides where an output lands. So the stream is cut into
// segments of SEG blocks of 624 words (156 SEG attempts each):
//
//  * pass A walks the stream in order in one block and saves each
//    segment's start (a checkpoint: the 624-word block numpy holds
//    there), then one block per segment regenerates its words from its
//    checkpoint and counts the accepted attempts, and one block scans the
//    counts.
//  * pass B, one block per segment again, regenerates the segment, ranks
//    its accepted attempts by a ballot scan on top of the segment's prefix,
//    and writes f x2 and f x1 in f64, rounded to f32 (then bf16), at their
//    places in C order. The block holding the last pair needed writes the
//    generator's state after it, as numpy leaves it.
//
// Bound: the walk takes ~1.06e6 dependent rounds of 624 words at the
// 26,431 x 9,852 tutorial shape (6.6e8 words), ~172 ms on one SM of the
// H100. Then the count and pass B each regenerate the stream once over all
// SMs, and pass B writes 1.04 GB and takes 1.3e8 f64 logs.
//
// The card's f64 log is within 1 ulp, libm's within about half an ulp, so
// f x differs from numpy's value in its last few bits at most; that moves
// the f32 rounding only where the f64 value lies within a few ulps of an
// f32 rounding midpoint. Every output within NEAR_TIE ulps of one is
// listed (its index, r2 and x), and the wrapper recomputes it with the
// host's libm, as numpy does. The arithmetic around the log uses the _rn
// intrinsics, so no multiply and add fuse into an FMA that numpy's C code
// does not take.
//
// Every entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MT_N = 624;
constexpr uint32_t MATRIX_A = 0x9908b0dfu;
constexpr uint32_t UPPER_MASK = 0x80000000u;
constexpr uint32_t LOWER_MASK = 0x7fffffffu;
constexpr int THREADS = 256;            // 227 regenerate, 156 take attempts
constexpr int WARPS = THREADS / 32;
constexpr int SCAN_THREADS = 1024;
constexpr int NEAR_TIE = 64;            // f64 ulps around an f32 rounding midpoint

// the layout of the int64 meta array (ops/init_draw.py reads it)
constexpr int META_TOTAL = 0;  // accepted pairs over all segments
constexpr int META_SEG = 1;    // the segment of the last pair needed; -1 if short
constexpr int META_POS = 2;    // the generator's pos after the draw
constexpr int META_NFIX = 3;   // outputs near an f32 midpoint (may exceed fix_cap)
constexpr int META_R2 = 4;     // the last pair's r2 and x1, as f64 bits
constexpr int META_X1 = 5;
constexpr int META_KEY = 8;    // the generator's 624 words after the draw

__device__ __forceinline__ uint32_t twist(uint32_t a, uint32_t b) {
  const uint32_t y = (a & UPPER_MASK) | (b & LOWER_MASK);
  return (y >> 1) ^ ((b & 1u) ? MATRIX_A : 0u);
}

// numpy's mt19937_gen: the next 624 words from `old` into `nw`. Thread t <
// 227 computes words t and t + 227 and, for t < 169, t + 454, each from the
// one before in registers; thread 169 also computes word 623 (from its word
// 396 and word 0, which it forms again). The caller synchronises after.
__device__ __forceinline__ void mt_regen(const uint32_t* __restrict__ old,
                                         uint32_t* __restrict__ nw, int t) {
  if (t >= 227) return;
  const uint32_t v1 = old[t + 397] ^ twist(old[t], old[t + 1]);
  const uint32_t v2 = v1 ^ twist(old[t + 227], old[t + 228]);
  nw[t] = v1;
  nw[t + 227] = v2;
  if (t < 169) {
    nw[t + 454] = v2 ^ twist(old[t + 454], old[t + 455]);
  } else if (t == 169) {
    const uint32_t w0 = old[397] ^ twist(old[0], old[1]);
    nw[623] = v2 ^ twist(old[623], w0);
  }
}

__device__ __forceinline__ uint32_t temper(uint32_t y) {
  y ^= y >> 11;
  y ^= (y << 7) & 0x9d2c5680u;
  y ^= (y << 15) & 0xefc60000u;
  return y ^ (y >> 18);
}

// numpy's legacy_double of two words, then 2 d - 1
__device__ __forceinline__ double polar_coord(uint32_t w0, uint32_t w1) {
  const double a = (double)(int32_t)(temper(w0) >> 5);
  const double b = (double)(int32_t)(temper(w1) >> 6);
  const double d = __ddiv_rn(__dadd_rn(__dmul_rn(a, 67108864.0), b), 9007199254740992.0);
  return __dsub_rn(__dmul_rn(2.0, d), 1.0);
}

struct Attempt {
  double x1, x2, r2;
  bool ok;
};

// attempt at word offset o of the block in `cur`, running on into `nxt`
__device__ __forceinline__ Attempt attempt_at(const uint32_t* cur, const uint32_t* nxt, int o) {
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) w[q] = o + q < MT_N ? cur[o + q] : nxt[o + q - MT_N];
  Attempt a;
  a.x1 = polar_coord(w[0], w[1]);
  a.x2 = polar_coord(w[2], w[3]);
  a.r2 = __dadd_rn(__dmul_rn(a.x1, a.x1), __dmul_rn(a.x2, a.x2));
  a.ok = a.r2 < 1.0 && a.r2 != 0.0;
  return a;
}

// out[idx] = v rounded to f32, then to bf16 when out is bf16
__device__ __forceinline__ void store(void* out, int out_bf16, long long idx, double v) {
  const float f = __double2float_rn(v);
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(f);
  else
    static_cast<float*>(out)[idx] = f;
}

// store() of v = f x, listed for the host when v lies near an f32 midpoint
__device__ __forceinline__ void put(void* out, int out_bf16, long long idx, double v,
                                    double r2, double x, long long* fix, long long fix_cap,
                                    long long* meta) {
  store(out, out_bf16, idx, v);
  const int low = (int)(__double_as_longlong(v) & 0x1fffffffLL);
  if (abs(low - 0x10000000) <= NEAR_TIE) {
    const unsigned long long slot =
        atomicAdd(reinterpret_cast<unsigned long long*>(meta + META_NFIX), 1ull);
    if ((long long)slot < fix_cap) {
      fix[3 * slot] = idx;
      fix[3 * slot + 1] = __double_as_longlong(r2);
      fix[3 * slot + 2] = __double_as_longlong(x);
    }
  }
}

// ---------------------------------------------------------------------------
// pass A
// ---------------------------------------------------------------------------

// One block walks the stream: checkpoint 0 is `key` (or the block after
// it when pos is 624, as numpy regenerates before its next word), and
// checkpoint k + 1 the block seg_blocks regenerations after checkpoint k.
__global__ void __launch_bounds__(THREADS)
walk_kernel(const uint32_t* __restrict__ key, int pos, int seg_blocks, int n_segments,
            uint32_t* __restrict__ ckpt) {
  __shared__ uint32_t buf[2][MT_N];
  const int t = threadIdx.x;
  for (int i = t; i < MT_N; i += THREADS) buf[0][i] = key[i];
  __syncthreads();
  int cur = 0;
  if (pos >= MT_N) {
    mt_regen(buf[0], buf[1], t);
    __syncthreads();
    cur = 1;
  }
  for (int k = 0;; ++k) {
    for (int i = t; i < MT_N; i += THREADS) ckpt[(size_t)k * MT_N + i] = buf[cur][i];
    if (k + 1 == n_segments) return;
    for (int j = 0; j < seg_blocks; ++j) {
      mt_regen(buf[cur], buf[cur ^ 1], t);
      __syncthreads();
      cur ^= 1;
    }
  }
}

// Round j of a segment takes the attempts that start in its block j at word
// offsets [lo, hi), every fourth word: from pos0 in block 0, to pos0 in
// block seg_blocks. Returns false when the round has none, and past block
// seg_blocks.
__device__ __forceinline__ bool round_range(int j, int pos0, int seg_blocks, int& lo, int& hi) {
  lo = j == 0 ? pos0 : (pos0 & 3);
  hi = j == seg_blocks ? pos0 : MT_N;
  return j <= seg_blocks && lo < hi;
}

// One block per segment: its accepted attempts.
__global__ void __launch_bounds__(THREADS)
count_kernel(const uint32_t* __restrict__ ckpt, int pos0, int seg_blocks,
             int* __restrict__ counts) {
  __shared__ uint32_t buf[2][MT_N];
  __shared__ int warp_sum[WARPS];
  const int t = threadIdx.x;
  for (int i = t; i < MT_N; i += THREADS) buf[0][i] = ckpt[(size_t)blockIdx.x * MT_N + i];
  __syncthreads();
  int cur = 0, acc = 0, lo, hi;
  for (int j = 0; round_range(j, pos0, seg_blocks, lo, hi); ++j) {
    mt_regen(buf[cur], buf[cur ^ 1], t);
    __syncthreads();
    const int o = lo + 4 * t;
    if (o < hi) acc += attempt_at(buf[cur], buf[cur ^ 1], o).ok;
    __syncthreads();
    cur ^= 1;
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if ((t & 31) == 0) warp_sum[t >> 5] = acc;
  __syncthreads();
  if (t == 0) {
    int total = 0;
    for (int w = 0; w < WARPS; ++w) total += warp_sum[w];
    counts[blockIdx.x] = total;
  }
}

// One block: excl[k] = pairs accepted before segment k; meta's total, the
// segment that holds pair n_pairs - 1, and the near-tie count zeroed.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(const int* __restrict__ counts, int n_segments, long long n_pairs,
            long long* __restrict__ excl, long long* __restrict__ meta) {
  __shared__ long long part[SCAN_THREADS];
  const int t = threadIdx.x;
  const int chunk = (n_segments + SCAN_THREADS - 1) / SCAN_THREADS;
  const int k0 = min(n_segments, t * chunk), k1 = min(n_segments, k0 + chunk);
  long long s = 0;
  for (int k = k0; k < k1; ++k) s += counts[k];
  part[t] = s;
  if (t == 0) {
    meta[META_SEG] = -1;
    meta[META_NFIX] = 0;
  }
  __syncthreads();
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {  // inclusive Hillis-Steele
    const long long add = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += add;
    __syncthreads();
  }
  long long run = part[t] - s;
  for (int k = k0; k < k1; ++k) {
    excl[k] = run;
    if (run < n_pairs && run + counts[k] >= n_pairs) meta[META_SEG] = k;
    run += counts[k];
  }
  if (t == SCAN_THREADS - 1) meta[META_TOTAL] = part[t];
}

// ---------------------------------------------------------------------------
// pass B
// ---------------------------------------------------------------------------

// One block per segment up to the one that holds the last pair needed.
// Pair p lands at out[head + 2p] (f x2) and out[head + 2p + 1] (f x1, when
// inside n_out); with head 1 the cached Gaussian takes out[0]. A null out
// writes nothing and still leaves the state (numpy's discarded draw).
__global__ void __launch_bounds__(THREADS)
write_kernel(const uint32_t* __restrict__ ckpt, int pos0, int seg_blocks,
             const long long* __restrict__ excl, long long* __restrict__ meta,
             long long n_pairs, long long n_out, int head, double head_value, void* out,
             int out_bf16, long long* __restrict__ fix, long long fix_cap) {
  __shared__ uint32_t buf[2][MT_N];
  __shared__ int warp_cnt[WARPS];
  __shared__ int final_buf;
  const long long last_seg = meta[META_SEG];
  const int k = blockIdx.x;
  if (last_seg < 0 || k > last_seg) return;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (k == 0 && t == 0 && head && out)
    store(out, out_bf16, 0, __dadd_rn(0.0, head_value));  // numpy's own f64: exact
  for (int i = t; i < MT_N; i += THREADS) buf[0][i] = ckpt[(size_t)k * MT_N + i];
  if (t == 0) final_buf = -1;
  __syncthreads();
  long long run = excl[k];
  int cur = 0, lo, hi;
  for (int j = 0; round_range(j, pos0, seg_blocks, lo, hi); ++j) {
    mt_regen(buf[cur], buf[cur ^ 1], t);
    __syncthreads();
    const int o = lo + 4 * t;
    Attempt a;
    a.ok = false;
    if (o < hi) a = attempt_at(buf[cur], buf[cur ^ 1], o);
    const unsigned ballot = __ballot_sync(0xffffffffu, a.ok);
    if (lane == 0) warp_cnt[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      before += w < warp ? warp_cnt[w] : 0;
      total += warp_cnt[w];
    }
    const long long p = run + before + __popc(ballot & ((1u << lane) - 1u));
    if (a.ok && p < n_pairs) {
      if (out) {
        const double f = __dsqrt_rn(__ddiv_rn(__dmul_rn(-2.0, log(a.r2)), a.r2));
        const long long idx = head + 2 * p;
        put(out, out_bf16, idx, __dadd_rn(0.0, __dmul_rn(f, a.x2)), a.r2, a.x2, fix, fix_cap,
            meta);
        if (idx + 1 < n_out)
          put(out, out_bf16, idx + 1, __dadd_rn(0.0, __dmul_rn(f, a.x1)), a.r2, a.x1, fix,
              fix_cap, meta);
      }
      if (p == n_pairs - 1) {  // the last word read is o + 3
        final_buf = o + 3 < MT_N ? cur : cur ^ 1;
        meta[META_POS] = (o + 3) % MT_N + 1;
        meta[META_R2] = __double_as_longlong(a.r2);
        meta[META_X1] = __double_as_longlong(a.x1);
      }
    }
    run += total;
    __syncthreads();
    if (final_buf >= 0) {
      for (int i = t; i < MT_N; i += THREADS) meta[META_KEY + i] = buf[final_buf][i];
      return;
    }
    cur ^= 1;
  }
}

}  // namespace

extern "C" int tg_normal_pass_a(const uint32_t* key, int pos, int seg_blocks, int n_segments,
                                long long n_pairs, uint32_t* ckpt, int* counts, long long* excl,
                                long long* meta, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  walk_kernel<<<1, THREADS, 0, s>>>(key, pos, seg_blocks, n_segments, ckpt);
  count_kernel<<<n_segments, THREADS, 0, s>>>(ckpt, pos % MT_N, seg_blocks, counts);
  scan_kernel<<<1, SCAN_THREADS, 0, s>>>(counts, n_segments, n_pairs, excl, meta);
  return (int)cudaGetLastError();
}

extern "C" int tg_normal_pass_b(const uint32_t* ckpt, int pos, int seg_blocks, int n_segments,
                                const long long* excl, long long* meta, long long n_pairs,
                                long long n_out, int head, double head_value, void* out,
                                int out_bf16, long long* fix, long long fix_cap, void* stream) {
  write_kernel<<<n_segments, THREADS, 0, (cudaStream_t)stream>>>(
      ckpt, pos % MT_N, seg_blocks, excl, meta, n_pairs, n_out, head, head_value, out, out_bf16,
      fix, fix_cap);
  return (int)cudaGetLastError();
}
