// Int8 (W8A8) non-causal flash attention forward for Hopper (sm_90a), and
// the two passes that quantise its bf16 inputs.
//
// Replaces the Pallas TPU kernel tweediemix_tpu/ops/flash_attention.py
// `_flash_kernel_int8` (wrapper `flash_attention(..., int8_qkpv=True)`,
// dispatched by tweediemix_tpu/ops/attention.py::attention when
// TWEEDIEMIX_FLASH_INT8=1) and that wrapper's quantise. It computes the same
// function. q is pre-scaled by scale*log2(e) and rounded back to bf16; q, k
// and v are quantised with per-tensor abs-max scales s = max(absmax,
// 1e-12)/127 and scales = {score_scale = q_s*k_s, out_scale = 127*v_s}. For
// each query row and each tile of BN keys:
//
//     s   = float(q8 . k8) * score_scale          (keys past Sk: masked)
//     m'  = max(m, max s);  corr = exp2(m - m');  p = exp2(s - m')
//     p8  = round_half_even(127 p)
//     acc = acc * corr + float(p8 . v8)
//     den = den * corr + 127 * sum p8     (dh % 128 != 0: the TPU kernel's
//                                          127 column of v)
//     den = den * corr + sum p            (dh % 128 == 0)
//     o   = acc / max(den, 1) * out_scale               (dh % 128 != 0)
//     o   = acc / max(den, 1e-30) * (out_scale / 127^2) (dh % 128 == 0)
//
// p8 is quantised against the running max of the tiles seen so far, so the
// result depends on the tile width BN (128 keys at dh 64, 64 at dh 128, 32
// at dh 256): the plain version (flash_attention_int8_core_reference) takes
// the same block_k (INT8_BLOCK_K in ops/flash_attention.py,
// tm_int8_block_k below).
//
// What bounds it on an H100. Both products take 4*D int8 operations per
// score on the tensor cores, 8192 per clock per SM (1979 TOP/s): at dh 64 a
// score costs 1/32 of an SM clock there, 0.347 ms at (160, 4096, 4096, 64).
// The softmax costs the same per score at any dh, and on an int8 kernel it
// is the larger bound. One exp2 per score on the special-function units (16
// per clock per SM) takes 1/16 of a clock: 0.695 ms at that shape, at the
// clock of the tensor peak. The conversions an int8 softmax adds (s32 score
// to fp32, the round of 127 p, the s32 P.V partial to fp32) run at 16 per
// clock too if written as casts (I2F, F2I), which would triple that floor.
// Every instruction also takes an issue slot (128 per clock per SM): the
// dh-64 loop below issues about 10 instructions per score (its SASS, the
// path of a tile that is not the last, P.V fold and loop included), 0.87 ms
// at the same shape. So at dh 64 the softmax floors are 2-2.5 times the
// tensor bound, and the design keeps the tensor cores fed without the
// threads' help and the softmax short:
//   * one block of three warpgroups per 128 query rows of one (b, h): a
//     producer warpgroup (its registers lowered to 24 by setmaxnreg) whose
//     one thread issues every TMA load, and two consumer warpgroups (raised
//     to 240) of 64 query rows each;
//   * TMA through 3-D tensor maps, Q once, K [BN keys][D] and V^T [D][BN
//     keys] once per key tile into a ring of three stages (`full` mbarriers
//     counted in bytes, an `empty` mbarrier handing a stage back), each tile
//     with the swizzle of its row width (128, 64 or 32 bytes), so rows past
//     Sq or Sk in one head read as zeros;
//   * S = Q.K^T as wgmma m64nBNk32 .s32.s8.s8 from shared memory, and O's
//     tile partial as wgmma .s32.s8.s8 with P8 from registers, in two parts
//     of D/2 columns (dh 64 and 128) or 128 (dh 256), the first overlapping
//     the softmax and the second issued after it: ptxas gives the
//     consumers' code no more than the 168 registers of the kernel's entry
//     (setmaxnreg notwithstanding), and a P.V partial of D s32 columns beside
//     S, P8 and O spilled at dh 64 and 128 (dh 256 spills anyway and is on
//     no path). 8-bit wgmma takes
//     both operands K-major, so V arrives transposed: the quantise pass
//     writes V^T [BH, D, Skp], Skp = Sk padded with zeros to a multiple of
//     BN. The s32 accumulator gives a thread columns 2t, 2t+1 of each n8
//     group while the s8 A fragment wants four consecutive k, so the keys of
//     each 32-key step of V^T are stored permuted (position 4t+i holds key
//     2t + (i&1) + 8(i>>1), +16 in the upper half): P8's A fragment is then
//     packed from values the thread already holds;
//   * tile n's Q.K^T is issued together with tile n-1's P.V, and tile n's
//     softmax runs while both are in flight; two named barriers hand the
//     tensor cores from one consumer to the other;
//   * the softmax keeps its conversions off the 16-per-clock pipes: the
//     running max m is kept as an s32 score, and a score x enters the
//     exponent (x - m) * sc as __int_as_float(x + 0x4B400000 - m) = 1.5 *
//     2^23 + (x - m) (exact while |x - m| < 2^22, which 2 * 127^2 * dh is at
//     dh 64 and 128) in one integer add and one FMA, (1.5 * 2^23 + x - m) *
//     sc_hi - 1.5 * 2^23 * sc_hi, whose addend is exact (sc_hi: sc with its
//     two lowest mantissa bits cleared), so the exponent is rounded once and
//     never exceeds 0: p8 <= 127. (A rounded addend 1.5 * 2^23 * sc + m
//     would shift a row's exponents by up to one ulp of 1.26e7 * sc: that
//     doubles the kernel-vs-plain error at dh 64 and, above sc ~ 0.01,
//     lifts a row max's p8 to 128, -128 as an s8 operand;
//     tools/int8_variants.py measures both.) dh 256 converts x - m with a
//     cast;
//     round(127 p) is fmaf(p, 127, 1.5 * 2^23), whose low byte is p8 and
//     whose bits summed as integers give sum p8; prmt packs four p8 into a
//     register; the P.V partial (at most 127^2 * BN) converts the same way
//     and is folded in as acc = fma(acc, corr, pv). One exp2 in 8 runs as
//     the FMA-unit polynomial hopper::exp2_fma at dh 64 (none at dh 128 and
//     256), the share that ran fastest on an H100 of none, 1 in 16 and 1 in
//     8: the exp2 unit and the issue slots set about the same floor;
//   * keys past Sk are masked on the last tile only (a second instance of
//     the softmax); the output is stored from registers, rows past Sq
//     skipped.
//
// The two quantise passes (plain version: quantize_qkv_int8 and
// pack_v_int8) are memory-bound and written plainly, 16 bytes a thread: pass
// 1 takes the abs-max of bf16(q * c), k and v in one launch (atomicMax on
// the float bits, the buffer zeroed with cudaMemsetAsync); pass 2 computes
// the scales on the device and writes q8, k8, the permuted, padded V^T and
// scales, rounding exactly as PyTorch does on the card.
//
// C interface (loaded with ctypes): see the extern "C" block below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTurnBarrier = 1;   // named barriers 1.. : the consumers' turns
// below every score (|q8 . k8| <= 127^2 * 256 < 2^22): a masked key's
// score, and the running max before the first tile
constexpr int kNoScore = -(1 << 30);

constexpr int kConsumers = 2;     // consumer warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockM = 64 * kConsumers;  // query rows per block
constexpr int kStages = 3;        // K/V^T tiles in the ring
constexpr int kProducerRegs = 24;  // setmaxnreg: 128 * (24 + 2 * 240) <= 65536
constexpr int kConsumerRegs = 240;
constexpr int kPartials = 4;      // partial maxes and sums per row
constexpr int kMagic = 0x4B400000;  // the bits of 1.5 * 2^23
constexpr float kMagicF = 12582912.f;

// The float whose bits are x + 0x4B400000: 1.5 * 2^23 + x, exact for |x| < 2^22.
__device__ __forceinline__ float magic_float(int x) {
  return __int_as_float(static_cast<int>(static_cast<uint32_t>(x) + kMagic));
}

// keys per tile at head dim d
constexpr int block_n(int d) { return d == 64 ? 128 : d == 128 ? 64 : 32; }

// One kernel configuration: D head dim, BN keys per tile, PvN columns of one
// P.V product (D / PvN of them per tile, one after the other), one exp2 in
// ExpEvery on the FMA units (0: none).
template <int D_, int BN_, int PvN_, int ExpEvery_>
struct Cfg {
  static constexpr int D = D_, BN = BN_, kPvN = PvN_, kExpEvery = ExpEvery_;
  static constexpr int kW = D < 128 ? D : 128;    // bytes per row of a Q or K panel
  static constexpr int kPanels = D / kW;
  static constexpr int kPvParts = D / kPvN;
  static constexpr int kQBytes = kBlockM * D;
  static constexpr int kTileBytes = BN * D;       // one K or V^T tile
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  // + 1 + 3 * kStages mbarriers, + 1024 to align the base for the swizzle
  static constexpr int kSmemBytes = kBarOffset + 8 * (1 + 3 * kStages) + 1024;
  static_assert(BN == block_n(D), "V^T is padded to the tile of its head dim");
  static_assert(kTileBytes % 1024 == 0 && kQBytes % 1024 == 0, "swizzle alignment");
  static_assert(kSmemBytes <= 232448, "shared memory");
};

template <int N>
__device__ __forceinline__ void wgmma_qk(int (&d)[N / 2], uint64_t a, uint64_t b, int scale_d);
template <>
__device__ __forceinline__ void wgmma_qk<32>(int (&d)[16], uint64_t a, uint64_t b, int s) {
  wgmma_s8_ss_m64n32(d, a, b, s);
}
template <>
__device__ __forceinline__ void wgmma_qk<64>(int (&d)[32], uint64_t a, uint64_t b, int s) {
  wgmma_s8_ss_m64n64(d, a, b, s);
}
template <>
__device__ __forceinline__ void wgmma_qk<128>(int (&d)[64], uint64_t a, uint64_t b, int s) {
  wgmma_s8_ss_m64n128(d, a, b, s);
}

template <int N>
__device__ __forceinline__ void wgmma_pv(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d);
template <>
__device__ __forceinline__ void wgmma_pv<32>(int (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                             int s) {
  wgmma_s8_rs_m64n32(d, a, b, s);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(int (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int s) {
  wgmma_s8_rs_m64n64(d, a, b, s);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(int (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                              int s) {
  wgmma_s8_rs_m64n128(d, a, b, s);
}

// s = q . k^T for this warpgroup's 64 rows and BN keys. q and k sit in
// shared memory as D / kW panels of [rows][kW bytes].
template <class C>
__device__ __forceinline__ void issue_qk(int (&s)[C::BN / 2], uint32_t q_addr, uint32_t k_addr) {
  const uint64_t dq = desc_kmajor(q_addr, C::kW), dk = desc_kmajor(k_addr, C::kW);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::D / 32; ++kk) {
    const uint32_t panel = kk * 32 / C::kW, step = kk * 32 % C::kW;
    wgmma_qk<C::BN>(s, desc_advance(dq, panel * kBlockM * C::kW + step),
                    desc_advance(dk, panel * C::BN * C::kW + step), kk > 0);
  }
  wgmma_commit();
}

// pv = p8 . v over BN keys and kPvN columns; p8 in registers, v^T [kPvN][BN
// bytes] in shared memory (K-major, the keys permuted as p8's are).
template <class C>
__device__ __forceinline__ void issue_pv(int (&pv)[C::kPvN / 2], const uint32_t (&p)[C::BN / 8],
                                         uint32_t vt_addr) {
  const uint64_t dv = desc_kmajor(vt_addr, C::BN);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::BN / 32; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_pv<C::kPvN>(pv, a, desc_advance(dv, kk * 32), kk > 0);
  }
  wgmma_commit();
}

// Accumulator layout of wgmma m64nN (per warp w of the warpgroup, g = lane /
// 4, t = lane % 4): d[4j + e] is row 16w + g + 8 * (e >> 1), column 8j + 2t +
// (e & 1). One thread holds parts of two rows; max and sum reduce over the
// four lanes of a quad, the sums only at the end (den is a per-thread
// partial: every step on it is linear).
//
// On return s holds, for each score, the bits of fmaf(p, 127, 1.5 * 2^23):
// an exact integer whose low byte is p8.
//
// The running max m_run is kept as an s32 score. A score's exponent (x -
// m) * sc is formed exactly up to its one rounding: x - m fits the magic
// float when 2 * 127^2 * D < 2^22 (dh 64 and 128), and (1.5 * 2^23 + x - m)
// * sc_hi - 1.5 * 2^23 * sc_hi is one FMA whose addend is exact (sc_hi is sc
// with its two lowest mantissa bits cleared, a relative change below 2^-22).
// Every exponent is <= 0, so p <= 1 and p8 <= 127.
template <class C, bool kLast>
__device__ __forceinline__ void softmax_int8(int (&s)[C::BN / 2], int (&m_run)[2],
                                             float (&den)[2], float (&corr)[2], float sc, int n0,
                                             int sk) {
  constexpr int BN = C::BN;
  constexpr bool kCountColumn = C::D % 128 != 0;  // the TPU kernel's 127 column of v
  constexpr bool kMagicDiff = 2 * 127 * 127 * C::D < (1 << 22);
  const int t = threadIdx.x % 4;
  if (kLast) {  // keys past sk take no part in the max
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (n0 + 8 * j + 2 * t + (e & 1) >= sk) s[4 * j + e] = kNoScore;
      }
    }
  }
  int ext[2][kPartials];
#pragma unroll
  for (int i = 0; i < kPartials; ++i) ext[0][i] = ext[1][i] = kNoScore;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int& x = ext[e >> 1][(2 * j + (e & 1)) % kPartials];
      x = max(x, s[4 * j + e]);
    }
  }
  const float sc_hi = __int_as_float(__float_as_int(sc) & ~3);
  const float bias = -kMagicF * sc_hi;  // exact: 3 * sc_hi's mantissa fits 24 bits
  int shift[2];  // adds 1.5 * 2^23 - m to a score's bits
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int x = ext[r][0];
#pragma unroll
    for (int i = 1; i < kPartials; ++i) x = max(x, ext[r][i]);
    x = max(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = max(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const int m_new = max(m_run[r], x);
    corr[r] = ex2(static_cast<float>(m_run[r] - m_new) * sc);
    m_run[r] = m_new;
    den[r] *= corr[r];
    shift[r] = kMagic - m_new;
  }
  uint32_t count[2][2] = {{0u, 0u}, {0u, 0u}};
  float sum[2][kPartials];
#pragma unroll
  for (int i = 0; i < kPartials; ++i) sum[0][i] = sum[1][i] = 0.f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const float x = kMagicDiff ? fmaf(__int_as_float(s[4 * j + e] + shift[r]), sc_hi, bias)
                                 : static_cast<float>(s[4 * j + e] - m_run[r]) * sc;
      constexpr int kEvery = C::kExpEvery > 0 ? C::kExpEvery : 1;
      float p = C::kExpEvery > 0 && j % kEvery == kEvery - 1 ? exp2_fma(x) : ex2(x);
      if (kLast && n0 + 8 * j + 2 * t + (e & 1) >= sk) p = 0.f;
      const int y = __float_as_int(fmaf(p, 127.f, kMagicF));
      s[4 * j + e] = y;
      if (kCountColumn) {
        count[r][j & 1] += static_cast<uint32_t>(y);  // wraps; the magic is taken off below
      } else {
        sum[r][(2 * j + (e & 1)) % kPartials] += p;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kCountColumn) {
      const uint32_t n = count[r][0] + count[r][1] - (BN / 4) * static_cast<uint32_t>(kMagic);
      den[r] += 127.f * static_cast<float>(static_cast<int>(n));
    } else {
#pragma unroll
      for (int i = 0; i < kPartials; ++i) den[r] += sum[r][i];
    }
  }
}

// The p8 bytes of key columns 32kk..32kk+31, in the permuted key order of
// V^T, are the register A fragment of the kk-th k32 step of p8 . v.
template <int BN>
__device__ __forceinline__ void pack_p8(uint32_t (&p)[BN / 8], const int (&s)[BN / 2]) {
#pragma unroll
  for (int kk = 0; kk < BN / 32; ++kk) {
    const int* y = s + 16 * kk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // i = 0, 1: columns j, j + 1 (rows g, g + 8); i = 2, 3: j + 2, j + 3
      const int b = (i >> 1) * 8 + (i & 1) * 2;
      const uint32_t lo = __byte_perm(y[b], y[b + 1], 0x0040);
      const uint32_t hi = __byte_perm(y[b + 4], y[b + 5], 0x0040);
      p[4 * kk + i] = __byte_perm(lo, hi, 0x5410);
    }
  }
}

// acc[part] = acc[part] * corr + float(pv), the s32 partial converted
// exactly (|pv| <= 127^2 * BN < 2^22) on the integer and FMA pipes.
template <class C>
__device__ __forceinline__ void fold_pv(float (&acc)[C::D / 2], const int (&pv)[C::kPvN / 2],
                                        const float (&corr)[2], int part) {
#pragma unroll
  for (int i = 0; i < C::kPvN / 2; ++i) {
    float& a = acc[part * (C::kPvN / 2) + i];
    a = fmaf(a, corr[(i >> 1) & 1], magic_float(pv[i]) - kMagicF);
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads, 1)
    flash_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const float* __restrict__ scales, __nv_bfloat16* __restrict__ o,
                            int sq, int sk) {
  constexpr int D = C::D, BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* qs = smem;
  unsigned char* kvs = smem + C::kQBytes;  // stage st: K at tile 2*st, V^T at tile 2*st + 1
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
      for (int p = 0; p < C::kPanels; ++p) {
        tma_load_3d(qs + p * kBlockM * C::kW, &tq, q_full, p * C::kW, m0, bh);
      }
      int st = 0;
      uint32_t phase = 0;
      for (int n = 0; n < n_tiles; ++n) {
        mbar_wait(&empty[st], phase ^ 1);  // the first round passes at once
        unsigned char* ks = kvs + (2 * st) * C::kTileBytes;
        mbar_arrive_expect_tx(&k_full[st], C::kTileBytes);
#pragma unroll
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load_3d(ks + p * BN * C::kW, &tk, &k_full[st], p * C::kW, n * BN, bh);
        }
        mbar_arrive_expect_tx(&v_full[st], C::kTileBytes);
        tma_load_3d(ks + C::kTileBytes, &tv, &v_full[st], n * BN, 0, bh);
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
    const uint32_t q_addr = smem_u32(qs) + c * 64 * C::kW;
    const uint32_t kv_addr = smem_u32(kvs);
    const float sc = scales[0];

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    int s[BN / 2];
    uint32_t p[BN / 8];
    int pv[C::kPvN / 2];
    int m_run[2] = {kNoScore, kNoScore};
    float den[2] = {0.f, 0.f};  // per-thread partial denominators
    float corr[2], corr_prev[2];

    // Turn-taking: the consumers issue their products in the order 0, 1, ..
    // Each waits for its turn before issuing and hands the turn to the next
    // after; the last consumer's final hand-over would have no taker and is
    // skipped.
    if (last_consumer) named_bar_arrive(kTurnBarrier, 256);
    mbar_wait(q_full, 0);

    // tile 0: s = q . k^T, softmax
    mbar_wait(&k_full[0], 0);
    named_bar_sync(my_turn, 256);
    issue_qk<C>(s, q_addr, kv_addr);
    if (!(last_consumer && n_tiles == 1)) named_bar_arrive(next_turn, 256);
    wgmma_wait<0>();
    fence_regs(s);
    if (n_tiles == 1) {
      softmax_int8<C, true>(s, m_run, den, corr, sc, 0, sk);
    } else {
      softmax_int8<C, false>(s, m_run, den, corr, sc, 0, sk);
    }
    pack_p8<BN>(p, s);

    int st = 0;  // stage of tile n - 1
    uint32_t phase = 0;
    for (int n = 1; n < n_tiles; ++n) {
      const int st_n = st + 1 == kStages ? 0 : st + 1;
      const uint32_t phase_n = st_n == 0 ? phase ^ 1 : phase;
      const uint32_t vt_addr = kv_addr + (2 * st + 1) * C::kTileBytes;
      mbar_wait(&k_full[st_n], phase_n);
      named_bar_sync(my_turn, 256);
      issue_qk<C>(s, q_addr, kv_addr + (2 * st_n) * C::kTileBytes);
      mbar_wait(&v_full[st], phase);
      issue_pv<C>(pv, p, vt_addr);  // tile n - 1, first part
      if (!(last_consumer && n == n_tiles - 1)) named_bar_arrive(next_turn, 256);
      wgmma_wait<1>();  // q . k^T of tile n done
      fence_regs(s);
      corr_prev[0] = corr[0];
      corr_prev[1] = corr[1];
      if (n == n_tiles - 1) {
        softmax_int8<C, true>(s, m_run, den, corr, sc, n * BN, sk);
      } else {
        softmax_int8<C, false>(s, m_run, den, corr, sc, n * BN, sk);
      }
      wgmma_wait<0>();  // p8 . v of tile n - 1 done
      fence_regs(pv);
      fence_regs(p);
      fold_pv<C>(acc, pv, corr_prev, 0);
#pragma unroll
      for (int part = 1; part < C::kPvParts; ++part) {
        issue_pv<C>(pv, p, vt_addr + part * C::kPvN * BN);
        wgmma_wait<0>();
        fence_regs(pv);
        fence_regs(p);
        fold_pv<C>(acc, pv, corr_prev, part);
      }
      mbar_arrive(&empty[st]);  // tile n - 1's stage is free
      pack_p8<BN>(p, s);
      st = st_n;
      phase = phase_n;
    }

    // the last tile's p8 . v
    mbar_wait(&v_full[st], phase);
#pragma unroll
    for (int part = 0; part < C::kPvParts; ++part) {
      issue_pv<C>(pv, p, kv_addr + (2 * st + 1) * C::kTileBytes + part * C::kPvN * BN);
      wgmma_wait<0>();
      fence_regs(pv);
      fence_regs(p);
      fold_pv<C>(acc, pv, corr, part);
    }

    constexpr bool kCountColumn = D % 128 != 0;
    const float out_scale = scales[1];
    const float post = kCountColumn ? out_scale : __fdiv_rn(out_scale, 16129.f);  // / 127^2
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float d = den[r];
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      inv[r] = __fdiv_rn(post, fmaxf(d, kCountColumn ? 1.f : 1e-30f));
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

template <class C>
cudaError_t launch(const void* q8, const void* k8, const void* vt8, const void* scales, void* o,
                   int bh, int sq, int sk, cudaStream_t stream) {
  // The shared-memory attribute is set once per instance and device.
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (!bit || !(attr_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(flash_int8_wgmma_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return err;
    attr_set.fetch_or(bit, std::memory_order_release);
  }
  const int skp = (sk + C::BN - 1) / C::BN * C::BN;
  CUtensorMap tq, tk, tv;
  if (!encode_s8_3d(&tq, q8, bh, sq, C::D, kBlockM, C::kW) ||
      !encode_s8_3d(&tk, k8, bh, sk, C::D, C::BN, C::kW) ||
      !encode_s8_3d(&tv, vt8, bh, C::D, skp, C::D, C::BN)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_int8_wgmma_kernel<C><<<grid, kThreads, C::kSmemBytes, stream>>>(
      tq, tk, tv, static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(o), sq, sk);
  return cudaGetLastError();
}

// ---- the quantise passes --------------------------------------------------

constexpr int kQuantThreads = 256;
constexpr int kVtKeys = 32;  // keys per V^T tile of pass 2: one permutation step
constexpr int kVtStride = kVtKeys + 16;

// bf16(x * c), as the plain version rounds the pre-scaled q
__device__ __forceinline__ float prescale(float x, float c) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, c)));
}

// max(absmax, 1e-12) / 127 as PyTorch computes it on the card (a division
// by a Python scalar is a multiply by its rounded reciprocal there)
__device__ __forceinline__ float quant_scale(uint32_t absmax_bits) {
  return __fmul_rn(fmaxf(__uint_as_float(absmax_bits), 1e-12f), __fdiv_rn(1.f, 127.f));
}

__device__ __forceinline__ int quantize(float x, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, s)), -127.f), 127.f));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Pass 1: absmax[0..2] = max |bf16(q * c)|, max |k|, max |v| (blockIdx.y picks
// the tensor), as float bits; absmax is zeroed before the launch.
__global__ void __launch_bounds__(kQuantThreads)
    absmax_kernel(const uint4* __restrict__ q, const uint4* __restrict__ k,
                  const uint4* __restrict__ v, long long nq, long long nk, float c,
                  uint32_t* __restrict__ absmax) {
  const int which = blockIdx.y;
  const uint4* src = which == 0 ? q : which == 1 ? k : v;
  const long long n = which == 0 ? nq : nk;  // 16-byte chunks
  float m = 0.f;
  for (long long i = blockIdx.x * static_cast<long long>(kQuantThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kQuantThreads) {
    float f[8];
    unpack8(src[i], f);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(which == 0 ? prescale(f[e], c) : f[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kQuantThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kQuantThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(absmax + which, __float_as_uint(m));
  }
}

// Position, within its 32-key step, of key `key` of that step in V^T.
__device__ __forceinline__ int permuted_pos(int key) {
  const int kk = key & 15;
  return (key & 16) + 4 * ((kk >> 1) & 3) + (kk & 1) + 2 * (kk >> 3);
}

// Pass 2: the scales, q8 and k8 (the first flat_blocks blocks, 8 values a
// thread), and V^T [bh, D, skp] (one block per 32 keys of one head, through
// shared memory), zeros past sk.
template <int D>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_kernel(const uint4* __restrict__ q, const uint4* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, uint2* __restrict__ q8,
                    uint2* __restrict__ k8, int8_t* __restrict__ vt, long long nq, long long nk,
                    int flat_blocks, int sk, int skp, float c,
                    const uint32_t* __restrict__ absmax, float* __restrict__ scales) {
  const float s_q = quant_scale(absmax[0]), s_k = quant_scale(absmax[1]);
  const float s_v = quant_scale(absmax[2]);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    scales[0] = __fmul_rn(s_q, s_k);
    scales[1] = __fmul_rn(127.f, s_v);
  }
  if (static_cast<int>(blockIdx.x) < flat_blocks) {
    for (long long i = blockIdx.x * static_cast<long long>(kQuantThreads) + threadIdx.x;
         i < nq + nk; i += static_cast<long long>(flat_blocks) * kQuantThreads) {
      const bool is_q = i < nq;
      float f[8];
      unpack8(is_q ? q[i] : k[i - nq], f);
      int b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) b[e] = quantize(is_q ? prescale(f[e], c) : f[e], is_q ? s_q : s_k);
      (is_q ? q8[i] : k8[i - nq]) = make_uint2(pack4(b[0], b[1], b[2], b[3]),
                                               pack4(b[4], b[5], b[6], b[7]));
    }
    return;
  }
  __shared__ __align__(16) int8_t tile[D * kVtStride];
  const int tiles_per_head = skp / kVtKeys;
  const int t = blockIdx.x - flat_blocks;
  const int bh = t / tiles_per_head;
  const int n0 = (t % tiles_per_head) * kVtKeys;
  for (int i = threadIdx.x; i < kVtKeys * (D / 8); i += kQuantThreads) {
    const int key = i / (D / 8), col = (i % (D / 8)) * 8;
    int b[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (n0 + key < sk) {
      float f[8];
      unpack8(*reinterpret_cast<const uint4*>(v + (static_cast<size_t>(bh) * sk + n0 + key) * D + col),
              f);
#pragma unroll
      for (int e = 0; e < 8; ++e) b[e] = quantize(f[e], s_v);
    }
    const int pos = permuted_pos(key);
#pragma unroll
    for (int e = 0; e < 8; ++e) tile[(col + e) * kVtStride + pos] = static_cast<int8_t>(b[e]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < D * (kVtKeys / 16); i += kQuantThreads) {
    const int row = i / (kVtKeys / 16), chunk = (i % (kVtKeys / 16)) * 16;
    *reinterpret_cast<uint4*>(vt + (static_cast<size_t>(bh) * D + row) * skp + n0 + chunk) =
        *reinterpret_cast<const uint4*>(tile + row * kVtStride + chunk);
  }
}

template <int D>
cudaError_t quantize_as(const void* q, const void* k, const void* v, void* q8, void* k8, void* vt,
                        void* ws, int bh, int sq, int sk, float c, cudaStream_t stream) {
  uint32_t* absmax = static_cast<uint32_t*>(ws);
  float* scales = static_cast<float*>(ws) + 3;
  const long long nq = static_cast<long long>(bh) * sq * D / 8;
  const long long nk = static_cast<long long>(bh) * sk * D / 8;
  const int skp = (sk + block_n(D) - 1) / block_n(D) * block_n(D);
  cudaError_t err = cudaMemsetAsync(absmax, 0, 3 * sizeof(uint32_t), stream);
  if (err != cudaSuccess) return err;
  const long long per_block = kQuantThreads;
  const int grid1 = static_cast<int>(std::min<long long>((nq + per_block - 1) / per_block, 1056));
  absmax_kernel<<<dim3(grid1, 3), kQuantThreads, 0, stream>>>(
      static_cast<const uint4*>(q), static_cast<const uint4*>(k), static_cast<const uint4*>(v), nq,
      nk, c, absmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int flat = static_cast<int>(std::min<long long>((nq + nk + per_block - 1) / per_block, 2112));
  const long long vt_blocks = static_cast<long long>(bh) * (skp / kVtKeys);
  if (flat + vt_blocks > INT_MAX) return cudaErrorInvalidValue;
  quantize_kernel<D><<<static_cast<int>(flat + vt_blocks), kQuantThreads, 0, stream>>>(
      static_cast<const uint4*>(q), static_cast<const uint4*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<uint2*>(q8), static_cast<uint2*>(k8),
      static_cast<int8_t*>(vt), nq, nk, flat, sk, skp, c, absmax, scales);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Keys per tile of the kernel at head dim dh (0 for a dh it does not take):
// the plain version's block_k, and the multiple V^T's keys are padded to.
int tm_int8_block_k(int dh) {
  return dh == 64 || dh == 128 || dh == 256 ? block_n(dh) : 0;
}

// Both quantise passes. q [bh, sq, dh], k/v [bh, sk, dh]: contiguous bf16
// device pointers, 16-byte aligned; c = softmax scale * log2(e). Writes q8
// [bh, sq, dh], k8 [bh, sk, dh] and vt8 [bh, dh, skp] (skp = sk padded to a
// multiple of tm_int8_block_k(dh)) as int8, and ws: 3 words of abs-max
// scratch followed by scales {score_scale, out_scale} in fp32. Launches on
// `stream` without synchronising; returns a cudaError_t (0 on success).
int tm_quantize_qkv_int8(const void* q, const void* k, const void* v, void* q8, void* k8,
                         void* vt8, void* ws, int bh, int sq, int sk, int dh, float c,
                         void* stream) {
  if (bh < 1 || sq < 1 || sk < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return quantize_as<64>(q, k, v, q8, k8, vt8, ws, bh, sq, sk, c, s);
    case 128:
      return quantize_as<128>(q, k, v, q8, k8, vt8, ws, bh, sq, sk, c, s);
    case 256:
      return quantize_as<256>(q, k, v, q8, k8, vt8, ws, bh, sq, sk, c, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// q8 [bh, sq, dh], k8 [bh, sk, dh], vt8 [bh, dh, skp] as the quantise pass
// writes it: contiguous int8 device pointers, 16-byte aligned; scales: 2
// fp32 on the device {score_scale, out_scale}; o [bh, sq, dh] bf16. Encodes
// the three tensor maps, launches on `stream` without synchronising and
// returns the cudaError_t of the launch (0 on success).
int tm_flash_attention_int8(const void* q8, const void* k8, const void* vt8, const void* scales,
                            void* o, int bh, int sq, int sk, int dh, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return launch<Cfg<64, 128, 32, 8>>(q8, k8, vt8, scales, o, bh, sq, sk, s);
    case 128:
      return launch<Cfg<128, 64, 64, 0>>(q8, k8, vt8, scales, o, bh, sq, sk, s);
    case 256:
      return launch<Cfg<256, 32, 128, 0>>(q8, k8, vt8, scales, o, bh, sq, sk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* tm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
