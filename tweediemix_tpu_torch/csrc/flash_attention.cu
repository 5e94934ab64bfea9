// Non-causal flash attention forward for Hopper (sm_90a), bf16 operands,
// fp32 online softmax and accumulation.
//
// Replaces the Pallas TPU kernel tweediemix_tpu/ops/flash_attention.py
// `_flash_kernel` (wrapper `flash_attention`, dispatched by
// tweediemix_tpu/ops/attention.py::attention). It computes the same function:
//
//     o[bh, i, :] = sum_j softmax_j(q[bh, i] . k[bh, j] * scale) v[bh, j, :]
//
// over q [BH, Sq, D], k/v [BH, Sk, D] (contiguous, bf16), for D in
// {64, 128, 256} and any Sq, Sk >= 1. Keys past Sk are masked inside the
// kernel (no padded copies), the scale is folded with log2(e) into the fp32
// scores and the softmax uses exp2, the running max and denominator are
// fp32, the denominator is floored at 1e-30 like the TPU kernel's, and the
// output is bf16.
//
// What bounds it on an H100. At the main path's shapes (S = 1024 and 4096,
// D = 64) the work is 4*BH*Sq*Sk*D flops against 4*BH*S*D*2 bytes, about S/2
// flops per byte, far above the card's ~295 bf16 flops per byte: the tensor
// cores bound it (0.174 ms at (40, 4096, 4096, 64)). At D = 64 the softmax
// is a second bound just as high: one exp2 per score on the special-function
// units (16 per clock per SM) takes 1/16 of an SM clock, as do the score's
// 256 flops on the tensor cores (4096 per clock per SM), so at one clock the
// two floors are equal (0.174 ms at the same shape). So the design keeps the
// tensor cores fed from shared memory without the threads' help, and runs
// one warpgroup's exponentials while the other's products run:
//   * one block of three warpgroups per 128 query rows of one (b, h): a
//     producer warpgroup (its registers lowered to 24 by setmaxnreg) whose
//     one thread issues every load, and two consumer warpgroups (raised to
//     240) of 64 query rows each, so every K/V tile is read once per 128
//     queries;
//   * TMA loads of Q once and of K and V tiles of BN keys (128 at D = 64, 64
//     at D = 128, 32 at D = 256, so that the S, P and O registers fit the
//     consumers' 240 without spilling) into a ring of three stages, through
//     3-D tensor maps over [BH, S, D] with 128-byte swizzle, so rows past Sq
//     or Sk in one head read as zeros, never the next head's rows; `full`
//     mbarriers (counted in bytes) hand a stage to the consumers and an
//     `empty` mbarrier hands it back;
//   * S = Q.K^T as wgmma m64nBNk16 with both operands in shared memory
//     (K-major descriptors), O += P.V as wgmma m64nDk16 with P from
//     registers (the fp32 accumulator of S packed to bf16x2 is the register A
//     fragment) and V through a transposed (MN-major) descriptor;
//   * within a consumer, tile n's Q.K^T is issued together with tile n-1's
//     P.V, and tile n's softmax runs while both are in flight; across the two
//     consumers, two named barriers hand the tensor cores back and forth
//     ("ping-pong"), so one warpgroup's softmax overlaps the other's
//     products;
//   * at D = 64 the softmax, not the products, sets the pace, so it is kept
//     short: the row max is taken on the unscaled scores and the scale is
//     folded into the exponent's FMA, and max and sum run over four partial
//     values per row instead of one chain; the key mask costs only the last
//     key tile (a branch); the output is stored straight from registers
//     with rows past Sq skipped.
//
// C interface (loaded with ctypes): see tm_flash_attention_bf16 below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTurnBarrier = 1;   // named barriers 1.. : the consumers' turns
constexpr float kNegInf = -1e30f; // the TPU kernel's NEG_INF

constexpr int kConsumers = 2;     // consumer warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockM = 64 * kConsumers;  // query rows per block
constexpr int kStages = 3;        // K/V tiles in the ring
constexpr int kProducerRegs = 24;  // setmaxnreg: 128 * (24 + 2 * 240) <= 65536
constexpr int kConsumerRegs = 240;

// One kernel configuration: D head dim, BN keys per K/V tile.
template <int D_, int BN_>
struct Cfg {
  static constexpr int D = D_, BN = BN_;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = BN * D * 2;  // one K or V tile
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  // + 1 + 3 * kStages mbarriers, + 1024 to align the base for the swizzle
  static constexpr int kSmemBytes = kBarOffset + 8 * (1 + 3 * kStages) + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory");
};

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b, int s) {
  wgmma_ss_m64n32(d, a, b, s);
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a, uint64_t b, int s) {
  wgmma_ss_m64n64(d, a, b, s);
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a, uint64_t b, int s) {
  wgmma_ss_m64n128(d, a, b, s);
}

template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_m64n64_tb(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs_tb<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_m64n128_tb(d, a, b);
}
template <>
__device__ __forceinline__ void wgmma_rs_tb<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_m64n256_tb(d, a, b);
}

// s = q . k^T for this warpgroup's 64 rows and BN keys. q and k sit in
// shared memory as D/64 panels of [rows][64] (128-byte rows, swizzled);
// q_panel and k_panel are the panels' byte strides.
template <int D, int BN>
__device__ __forceinline__ void issue_qk(float (&s)[BN / 2], uint32_t q_addr, uint32_t q_panel,
                                         uint32_t k_addr) {
  const uint64_t dq = desc_sw128(q_addr, 0), dk = desc_sw128(k_addr, 0);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;  // k16 step inside a 64-wide panel
    wgmma_ss<BN>(s, desc_advance(dq, (kk / 4) * q_panel + step),
                 desc_advance(dk, (kk / 4) * (BN * 128) + step), kk > 0);
  }
  wgmma_commit();
}

// o += p . v over BN keys; p [64, BN] in registers as bf16x2, v [BN, D] in
// shared memory as D/64 panels of [BN][64] (MN-major for this product).
template <int D, int BN>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[BN / 4],
                                         uint32_t v_addr) {
  const uint64_t dv = desc_sw128(v_addr, BN * 128);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_rs_tb<D>(o, a, desc_advance(dv, kk * 16 * 128));
  }
  wgmma_commit();
}

// Accumulator layout of wgmma m64nN (per warp w of the warpgroup, g = lane / 4,
// t = lane % 4): d[4j + e] is row 16w + g + 8 * (e >> 1), column 8j + 2t + (e & 1).
// One thread holds parts of two rows; the row max and sum reduce over the
// four lanes of a quad.
//
// The scale is folded into the exponent's FMA: the row extremum is taken on
// the unscaled scores (the max for a scale >= 0, the min for kNegScale), so
// scaled scores are never materialised. Max and sum run over four partial
// values per row so that a single warp's softmax is not one long chain of
// dependent instructions (the other consumer's products are all that
// overlaps it). With kSplitExp one score in eight takes exp2_fma, which
// moves that share of the exponentials from the exp2 unit (16 per clock per
// SM) to the FMA units, which have room; at D = 64 the exp2 unit alone would
// take about as long as both products.
constexpr int kPartials = 4;

template <int BN, bool kNegScale, bool kSplitExp>
__device__ __forceinline__ void online_softmax(float (&s)[BN / 2], float (&m_run)[2],
                                               float (&l_run)[2], float (&corr)[2],
                                               float scale_log2, int n0, int sk, bool last) {
  const float inf = __int_as_float(0x7f800000);
  if (last) {  // keys past sk: scaled to -inf, so that their exp2 is exactly 0
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n0 + 8 * j + 2 * t + (e & 1) >= sk) s[4 * j + e] = kNegScale ? inf : -inf;
      }
    }
  }
  float ext[2][kPartials];
#pragma unroll
  for (int i = 0; i < kPartials; ++i) ext[0][i] = ext[1][i] = kNegScale ? inf : -inf;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float& x = ext[e >> 1][(2 * j + (e & 1)) % kPartials];
      x = kNegScale ? fminf(x, s[4 * j + e]) : fmaxf(x, s[4 * j + e]);
    }
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = ext[r][0];
#pragma unroll
    for (int i = 1; i < kPartials; ++i) {
      x = kNegScale ? fminf(x, ext[r][i]) : fmaxf(x, ext[r][i]);
    }
#pragma unroll
    for (int lane = 1; lane <= 2; lane *= 2) {
      const float y = __shfl_xor_sync(0xffffffffu, x, lane);
      x = kNegScale ? fminf(x, y) : fmaxf(x, y);
    }
    const float m_new = fmaxf(m_run[r], x * scale_log2);  // the row's max scaled score
    corr[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
    l_run[r] *= corr[r];
    neg_m[r] = -m_new;
  }
  float sum[2][kPartials];
#pragma unroll
  for (int i = 0; i < kPartials; ++i) sum[0][i] = sum[1][i] = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = fmaf(s[4 * j + e], scale_log2, neg_m[e >> 1]);
      const float p = kSplitExp && j % 8 == 7 ? exp2_fma(x) : ex2(x);
      s[4 * j + e] = p;
      sum[e >> 1][(2 * j + (e & 1)) % kPartials] += p;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 0; i < kPartials; ++i) l_run[r] += sum[r][i];
  }
}

// The probabilities of key columns 16kk..16kk+15 are the register A
// fragment of the kk-th k16 step of p . v.
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&p)[BN / 4], const float (&s)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    p[4 * kk + 0] = pack_bf16x2(s[8 * kk + 0], s[8 * kk + 1]);
    p[4 * kk + 1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    p[4 * kk + 2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    p[4 * kk + 3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__device__ __forceinline__ void scale_rows(float (&o)[D / 2], const float (&c)[2]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j + 0] *= c[0];
    o[4 * j + 1] *= c[0];
    o[4 * j + 2] *= c[1];
    o[4 * j + 3] *= c[1];
  }
}

template <class C, bool kNegScale>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                     int sq, int sk, float scale_log2) {
  constexpr int D = C::D, BN = C::BN;
  constexpr bool kSplitExp = D == 64;  // where the exp2 unit rivals the products
  constexpr int kPanels = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;
  unsigned char* kvs = smem + C::kQBytes;  // stage st: K at tile 2*st, V at tile 2*st + 1
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kStages;
  uint64_t* empty = bars + 1 + 2 * kStages;

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const int n_tiles = (sk + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], 128 * kConsumers);  // every consumer thread releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      mbar_arrive_expect_tx(q_full, C::kQBytes);
#pragma unroll
      for (int p = 0; p < kPanels; ++p) {
        tma_load_3d(qs + p * kBlockM * 128, &tq, q_full, 64 * p, m0, bh);
      }
      int st = 0;
      uint32_t phase = 0;
      for (int n = 0; n < n_tiles; ++n) {
        mbar_wait(&empty[st], phase ^ 1);  // the first round passes at once
        unsigned char* ks = kvs + (2 * st) * C::kTileBytes;
        unsigned char* vs = ks + C::kTileBytes;
        mbar_arrive_expect_tx(&k_full[st], C::kTileBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          tma_load_3d(ks + p * BN * 128, &tk, &k_full[st], 64 * p, n * BN, bh);
        }
        mbar_arrive_expect_tx(&v_full[st], C::kTileBytes);
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          tma_load_3d(vs + p * BN * 128, &tv, &v_full[st], 64 * p, n * BN, bh);
        }
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups of 64 query rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    const bool last_consumer = c == kConsumers - 1;
    const int my_turn = kTurnBarrier + c;
    const int next_turn = kTurnBarrier + (last_consumer ? 0 : c + 1);
    const uint32_t q_addr = smem_u32(qs) + c * 64 * 128;
    const uint32_t kv_addr = smem_u32(kvs);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float s[BN / 2];
    uint32_t p[BN / 4];
    float m_run[2] = {kNegInf, kNegInf};
    float l_run[2] = {0.f, 0.f};  // per-thread partial row sums
    float corr[2];

    // Turn-taking: the consumers issue their products in the order 0, 1, ..
    // Each waits for its turn before issuing and hands the turn to the next
    // after; the last consumer's final hand-over would have no taker and is
    // skipped.
    if (last_consumer) named_bar_arrive(kTurnBarrier, 256);
    mbar_wait(q_full, 0);

    // tile 0: s = q . k^T, softmax
    mbar_wait(&k_full[0], 0);
    named_bar_sync(my_turn, 256);
    issue_qk<D, BN>(s, q_addr, kBlockM * 128, kv_addr);
    if (!(last_consumer && n_tiles == 1)) named_bar_arrive(next_turn, 256);
    wgmma_wait<0>();
    fence_regs(s);
    online_softmax<BN, kNegScale, kSplitExp>(s, m_run, l_run, corr, scale_log2, 0, sk,
                                             n_tiles == 1);
    pack_p<BN>(p, s);

    int st = 0;  // stage of tile n - 1
    uint32_t phase = 0;
    for (int n = 1; n < n_tiles; ++n) {
      const int st_n = st + 1 == kStages ? 0 : st + 1;
      const uint32_t phase_n = st_n == 0 ? phase ^ 1 : phase;
      mbar_wait(&k_full[st_n], phase_n);
      named_bar_sync(my_turn, 256);
      issue_qk<D, BN>(s, q_addr, kBlockM * 128, kv_addr + (2 * st_n) * C::kTileBytes);
      scale_rows<D>(acc, corr);  // tile n - 1's rescale, before its p . v
      mbar_wait(&v_full[st], phase);
      issue_pv<D, BN>(acc, p, kv_addr + (2 * st + 1) * C::kTileBytes);
      if (!(last_consumer && n == n_tiles - 1)) named_bar_arrive(next_turn, 256);
      wgmma_wait<1>();  // q . k^T of tile n done
      fence_regs(s);
      online_softmax<BN, kNegScale, kSplitExp>(s, m_run, l_run, corr, scale_log2, n * BN,
                                               sk, n == n_tiles - 1);
      wgmma_wait<0>();  // p . v of tile n - 1 done: its stage and p are free
      fence_regs(acc);
      fence_regs(p);
      mbar_arrive(&empty[st]);
      pack_p<BN>(p, s);
      st = st_n;
      phase = phase_n;
    }

    // the last tile's p . v
    scale_rows<D>(acc, corr);
    mbar_wait(&v_full[st], phase);
    issue_pv<D, BN>(acc, p, kv_addr + (2 * st + 1) * C::kTileBytes);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(p);

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = 1.f / fmaxf(l, 1e-30f);
    }
    const int tid = threadIdx.x % 128;
    const int row = m0 + c * 64 + (tid / 32) * 16 + (tid % 32) / 4;
    __nv_bfloat16* orow = o + (static_cast<size_t>(bh) * sq + row) * D + 2 * (tid % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row < sq) {
        *reinterpret_cast<uint32_t*>(orow + j * 8) =
            pack_bf16x2(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
      }
      if (row + 8 < sq) {
        *reinterpret_cast<uint32_t*>(orow + 8 * D + j * 8) =
            pack_bf16x2(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
      }
    }
  }
}

template <class C, bool kNegScale>
cudaError_t launch_as(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                      int sk, float scale_log2, cudaStream_t stream) {
  // The shared-memory attribute is set once per instance and device, not
  // per launch (setting it twice from two threads is harmless).
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (!bit || !(attr_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<C, kNegScale>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return err;
    attr_set.fetch_or(bit, std::memory_order_release);
  }
  CUtensorMap tq, tk, tv;
  if (!encode_bf16_3d(&tq, q, bh, sq, C::D, kBlockM) ||
      !encode_bf16_3d(&tk, k, bh, sk, C::D, C::BN) ||
      !encode_bf16_3d(&tv, v, bh, sk, C::D, C::BN)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<C, kNegScale><<<grid, kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), sq, sk, scale_log2);
  return cudaGetLastError();
}

// A negative softmax scale takes the instance that reduces rows by their min.
template <class C>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
                   float scale_log2, cudaStream_t stream) {
  return scale_log2 < 0.f ? launch_as<C, true>(q, k, v, o, bh, sq, sk, scale_log2, stream)
                          : launch_as<C, false>(q, k, v, o, bh, sq, sk, scale_log2, stream);
}

}  // namespace

extern "C" {

// q [bh, sq, dh], k/v [bh, sk, dh], o [bh, sq, dh]: contiguous bf16 device
// pointers, 16-byte aligned. scale_log2 = softmax scale * log2(e). Encodes
// the three tensor maps, launches on `stream` without synchronising and
// returns the cudaError_t of the launch (0 on success).
int tm_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                            int sk, int dh, float scale_log2, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1) return cudaErrorInvalidValue;
  // A zero scale (uniform weights) runs as the least normal float: every
  // finite score then scales to within rounding of 0, while a masked key's
  // infinite score still scales to -inf rather than to 0 * inf = NaN.
  if (scale_log2 == 0.f) scale_log2 = FLT_MIN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return launch<Cfg<64, 128>>(q, k, v, o, bh, sq, sk, scale_log2, s);
    case 128:
      return launch<Cfg<128, 64>>(q, k, v, o, bh, sq, sk, scale_log2, s);
    case 256:
      return launch<Cfg<256, 32>>(q, k, v, o, bh, sq, sk, scale_log2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* tm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
