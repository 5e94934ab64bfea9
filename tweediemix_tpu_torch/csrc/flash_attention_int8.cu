// Int8 (W8A8) non-causal flash attention forward for Hopper (sm_90a): int8
// q/k/v, both products on the s8 tensor cores with int32 sums, fp32 online
// softmax, probabilities requantised to int8.
//
// Replaces the Pallas TPU kernel tweediemix_tpu/ops/flash_attention.py
// `_flash_kernel_int8` (wrapper `flash_attention(..., int8_qkpv=True)`,
// dispatched by tweediemix_tpu/ops/attention.py::attention when
// TWEEDIEMIX_FLASH_INT8=1). The wrapper (ops/flash_attention.py) pre-scales
// q by scale*log2(e), quantises q, k and v with per-tensor abs-max scales
// and passes scales = {score_scale = q_s*k_s, out_scale = 127*v_s}. For each
// query row and each tile of kBlockN keys the kernel computes, exactly as
// the TPU kernel does per key block:
//
//     s   = float(q8 . k8) * score_scale          (keys past Sk: -1e30)
//     m'  = max(m, max s);  corr = exp2(m - m');  p = exp2(s - m')
//     p8  = round_half_even(127 p)
//     acc = acc * corr + float(p8 . v8)
//     den = den * corr + 127 * sum p8     (dh % 128 != 0: the TPU kernel's
//                                          127 column of v)
//     l   = l * corr + sum p              (dh % 128 == 0)
//     o   = acc / max(den, 1) * out_scale               (dh % 128 != 0)
//     o   = acc / max(l, 1e-30) * (out_scale / 127^2)   (dh % 128 == 0)
//
// p8 is quantised against the running max of the tiles seen so far, so the
// result depends on the tile width: the plain version
// (flash_attention_int8_reference) takes block_k = kBlockN = 64. The
// scalings and corrections use __fmul_rn/__fdiv_rn so that no multiply is
// fused into an add and the rounding is the plain version's.
//
// What bounds it on an H100: 4*BH*Sq*Sk*D int8 operations at 1979 TOPS
// against q/k/v at 1 byte and o at 2 bytes per element at 3.35 TB/s; at the
// main path's shapes (S = 1024 and 4096, D = 64) the operations bound it by
// far. The design keeps the S x S scores out of device memory and runs both
// products as mma.sync.m16n8k32 s8 x s8 -> s32:
//   * one block of 4 warps per (64 query rows, bh); each warp owns 16 rows;
//     a loop over 64-key tiles with k in shared memory, row-major;
//   * the s32 accumulator of m16n8k32 gives a thread columns 2t, 2t+1 of
//     each n8 tile, while its s8 A operand wants four consecutive k. Instead
//     of a shuffle or a shared-memory round trip, the keys of each 32-key
//     step are permuted: A position 4t+i holds key 2t + (i&1) + 8*(i>>1)
//     (+16 for the upper half), which are exactly the p8 values the thread
//     already holds, and v's tile is stored with the same key order;
//   * ldmatrix .trans works on 16-bit elements only, so v's tile is
//     transposed (and permuted) on its way into shared memory, [D][keys],
//     which makes each B fragment one 32-bit load.
// It is deliberately simple: synchronous tile loads, scalar fragment loads,
// no TMA, no wgmma, no warp specialisation.
//
// C interface (loaded with ctypes): see tm_flash_attention_int8 below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // query rows per block
constexpr int kBlockN = 64;           // keys per tile (the plain version's block_k)
constexpr int kPad = 16;              // bytes of padding per shared-memory row
constexpr float kNegInf = -1e30f;     // the TPU kernel's NEG_INF

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | ((static_cast<uint32_t>(d) & 0xffu) << 24);
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x32, row-major) * b (32x8, column-major); s8 in, s32 out.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Key (within its 32-key step) at A/B position kp of that step.
__device__ __forceinline__ int permuted_key(int kp) {
  const int r = kp & 15;
  const int i = r & 3;
  return (kp & 16) + 2 * (r >> 2) + (i & 1) + 8 * (i >> 1);
}

// Rows [row0, row0 + nrows) of a [total_rows, D] int8 matrix into shared
// memory with a row stride of D + kPad bytes; rows past total_rows are 0.
template <int D>
__device__ __forceinline__ void load_rows(int8_t* dst, const int8_t* src, int row0, int nrows,
                                          int total_rows) {
  constexpr int kChunks = D / 16;
  constexpr int kStride = D + kPad;
  for (int i = threadIdx.x; i < nrows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < total_rows) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kStride + c) = val;
  }
}

// v rows [n0, n0 + kBlockN) transposed into vt [D][kBlockN + kPad], the keys
// of each 32-key step in permuted order; keys past sk are 0.
template <int D>
__device__ __forceinline__ void load_v_transposed(int8_t* vt, const int8_t* v, int n0, int sk) {
  constexpr int kStride = kBlockN + kPad;
  for (int i = threadIdx.x; i < D * (kBlockN / 4); i += kThreads) {
    const int n = i % D;
    const int kp = (i / D) * 4;
    int b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = n0 + (kp & ~31) + permuted_key((kp + e) & 31);
      b[e] = key < sk ? v[static_cast<size_t>(key) * D + n] : 0;
    }
    *reinterpret_cast<uint32_t*>(vt + n * kStride + kp) = pack4(b[0], b[1], b[2], b[3]);
  }
}

template <int D>
constexpr int smem_bytes() {
  return (kBlockM + kBlockN) * (D + kPad) + D * (kBlockN + kPad);
}

// Fragment layout of mma.m16n8k32 .s8 (g = lane / 4, t = lane % 4):
//   A regs: (row g, k 4t..4t+3), (row g+8, k 4t..), (row g, k 16+4t..), (row g+8, k 16+4t..)
//   B regs: (k 4t..4t+3, col g), (k 16+4t..16+4t+3, col g)
//   C/D:    (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1)
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_int8_fwd_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                          const int8_t* __restrict__ v, const float* __restrict__ scales,
                          __nv_bfloat16* __restrict__ o, int sq, int sk) {
  constexpr int kStride = D + kPad;
  constexpr int kVtStride = kBlockN + kPad;
  constexpr bool kCountColumn = D % 128 != 0;  // the TPU kernel's 127 column of v
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* qs = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* ks = qs + kBlockM * kStride;
  int8_t* vt = ks + kBlockN * kStride;

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t q_off = static_cast<size_t>(bh) * sq * D;
  const size_t kv_off = static_cast<size_t>(bh) * sk * D;
  const float score_scale = scales[0];
  const float out_scale = scales[1];

  load_rows<D>(qs, q + q_off, m0, kBlockM, sq);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  float m_run[2] = {kNegInf, kNegInf};
  float den[2] = {0.f, 0.f};  // the row's denominator (den or l above)
  const int8_t* qw = qs + warp * 16 * kStride;

  for (int n0 = 0; n0 < sk; n0 += kBlockN) {
    __syncthreads();  // previous tile fully consumed
    load_rows<D>(ks, k + kv_off, n0, kBlockN, sk);
    load_v_transposed<D>(vt, v + kv_off, n0, sk);
    __syncthreads();

    // s = q . k^T for this warp's 16 rows and kBlockN keys, in int32
    int s32[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
      s32[j][0] = s32[j][1] = s32[j][2] = s32[j][3] = 0;
    }
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      uint32_t a[4];
      const int8_t* qa = qw + kk * 32 + 4 * t;
      a[0] = ld_u32(qa + g * kStride);
      a[1] = ld_u32(qa + (g + 8) * kStride);
      a[2] = ld_u32(qa + g * kStride + 16);
      a[3] = ld_u32(qa + (g + 8) * kStride + 16);
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const int8_t* kb = ks + (j * 8 + g) * kStride + kk * 32 + 4 * t;
        mma_s8(s32[j], a, ld_u32(kb), ld_u32(kb + 16));
      }
    }

    // dequantise into the log2 domain, mask keys past sk, row max
    float s[kBlockN / 8][4];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const float val =
            col < sk ? __fmul_rn(static_cast<float>(s32[j][e]), score_scale) : kNegInf;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
    }

    // p, its int8 form p8 = round(127 p), and the row sums
    int p8[kBlockN / 8][4];
    int count[2] = {0, 0};
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_run[e >> 1]);
        p8[j][e] = __float2int_rn(__fmul_rn(p, 127.f));
        count[e >> 1] += p8[j][e];
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kCountColumn) {
        count[r] += __shfl_xor_sync(0xffffffffu, count[r], 1);
        count[r] += __shfl_xor_sync(0xffffffffu, count[r], 2);
        den[r] = __fmul_rn(den[r], corr[r]) + static_cast<float>(127 * count[r]);
      } else {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        den[r] = __fmul_rn(den[r], corr[r]) + psum[r];
      }
    }

    // A fragments of p8, keys in the permuted order of vt
    uint32_t pa[kBlockN / 32][4];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 32; ++kk) {
      const int j = 4 * kk;
      pa[kk][0] = pack4(p8[j][0], p8[j][1], p8[j + 1][0], p8[j + 1][1]);
      pa[kk][1] = pack4(p8[j][2], p8[j][3], p8[j + 1][2], p8[j + 1][3]);
      pa[kk][2] = pack4(p8[j + 2][0], p8[j + 2][1], p8[j + 3][0], p8[j + 3][1]);
      pa[kk][3] = pack4(p8[j + 2][2], p8[j + 2][3], p8[j + 3][2], p8[j + 3][3]);
    }

    // acc = acc * corr + float(p8 . v8), the tile's product summed in int32
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      int pv[4] = {0, 0, 0, 0};
      const int8_t* vb = vt + (j * 8 + g) * kVtStride + 4 * t;
#pragma unroll
      for (int kk = 0; kk < kBlockN / 32; ++kk) {
        mma_s8(pv, pa[kk], ld_u32(vb + kk * 32), ld_u32(vb + kk * 32 + 16));
      }
      acc[j][0] = __fmul_rn(acc[j][0], corr[0]) + static_cast<float>(pv[0]);
      acc[j][1] = __fmul_rn(acc[j][1], corr[0]) + static_cast<float>(pv[1]);
      acc[j][2] = __fmul_rn(acc[j][2], corr[1]) + static_cast<float>(pv[2]);
      acc[j][3] = __fmul_rn(acc[j][3], corr[1]) + static_cast<float>(pv[3]);
    }
  }

  float denom[2];
  float post;
  if (kCountColumn) {
    denom[0] = fmaxf(den[0], 1.f);
    denom[1] = fmaxf(den[1], 1.f);
    post = out_scale;
  } else {
    denom[0] = fmaxf(den[0], 1e-30f);
    denom[1] = fmaxf(den[1], 1e-30f);
    post = __fdiv_rn(out_scale, 16129.f);  // out_scale / 127^2
  }
  const int row = m0 + warp * 16 + g;
  __nv_bfloat16* orow = o + q_off + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row < sq) {
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_floats(__fmul_rn(__fdiv_rn(acc[j][0], denom[0]), post),
                      __fmul_rn(__fdiv_rn(acc[j][1], denom[0]), post));
    }
    if (row + 8 < sq) {
      *reinterpret_cast<uint32_t*>(orow + 8 * D + j * 8) =
          pack_floats(__fmul_rn(__fdiv_rn(acc[j][2], denom[1]), post),
                      __fmul_rn(__fdiv_rn(acc[j][3], denom[1]), post));
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* scales, void* o,
                   int bh, int sq, int sk, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D>();
  // The shared-memory attribute is set once per instance and device.
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (!bit || !(attr_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(flash_int8_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    attr_set.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_int8_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(scales),
      static_cast<__nv_bfloat16*>(o), sq, sk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q8 [bh, sq, dh], k8/v8 [bh, sk, dh]: contiguous int8 device pointers,
// 16-byte aligned; scales: 2 fp32 on the device {score_scale, out_scale};
// o [bh, sq, dh] bf16. Launches on `stream` without synchronising and
// returns the cudaError_t of the launch (0 on success).
int tm_flash_attention_int8(const void* q, const void* k, const void* v, const void* scales,
                            void* o, int bh, int sq, int sk, int dh, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, scales, o, bh, sq, sk, s);
    case 128:
      return launch<128>(q, k, v, scales, o, bh, sq, sk, s);
    case 256:
      return launch<256>(q, k, v, scales, o, bh, sq, sk, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* tm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
