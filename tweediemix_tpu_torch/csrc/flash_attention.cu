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
// kernel (no padded copies), the denominator is floored at 1e-30 like the
// TPU kernel, and the output has q's dtype.
//
// What bounds it on an H100: at the main path's shapes (S = 1024 and 4096,
// D = 64) the work is 4*BH*Sq*Sk*D flops against 4*BH*S*D*2 bytes, i.e.
// about S/2 flops per byte -- far above the card's ~295 bf16 flops/byte, so
// the tensor cores, not HBM, are the limit. The design therefore keeps the
// S x S scores out of device memory and runs both products on the tensor
// cores:
//   * one block of 4 warps per (64 query rows, bh); each warp owns 16 rows;
//   * a loop over 64-key tiles (32 at D = 256) staged in shared memory;
//   * q.k^T and p.v as mma.sync.m16n8k16 bf16 -> fp32, with the score
//     fragment re-packed in registers as the A operand of p.v (no shared
//     memory round trip for p);
//   * the softmax scale folded into the fp32 scores together with log2(e),
//     and exp2f for the exponentials; running max and sum per row in fp32.
// It is deliberately simple: plain synchronous tile loads, scalar fragment
// loads from padded shared memory, no TMA, no wgmma, no warp specialisation.
//
// C interface (loaded with ctypes): see tm_flash_attention_bf16 below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockM = 16 * kWarps;  // query rows per block
constexpr float kNegInf = -1e30f;     // the TPU kernel's NEG_INF

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_halves(__nv_bfloat16 lo,
                                                __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 out.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + nrows) of a [total_rows, D] bf16 matrix into
// shared memory with a row stride of D + 8 elements; rows past total_rows
// are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int nrows, int total_rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kStride = D + 8;
  for (int i = threadIdx.x; i < nrows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < total_rows) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * kStride + c) = val;
  }
}

template <int D, int BN>
constexpr int smem_bytes() {
  return (kBlockM + 2 * BN) * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A regs: (row g, k 2t..2t+1), (row g+8, k 2t..), (row g, k 2t+8..), (row g+8, k 2t+8..)
//   B regs: (k 2t..2t+1, col g), (k 2t+8..2t+9, col g)
//   C/D:    (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1)
template <int D, int BN>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int sq, int sk,
                     float scale_log2) {
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBlockM * kStride;
  __nv_bfloat16* vs = ks + BN * kStride;

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlockM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t q_off = static_cast<size_t>(bh) * sq * D;
  const size_t kv_off = static_cast<size_t>(bh) * sk * D;

  load_tile<D>(qs, q + q_off, m0, kBlockM, sq);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  float m_run[2] = {kNegInf, kNegInf};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums
  const __nv_bfloat16* qw = qs + warp * 16 * kStride;

  for (int n0 = 0; n0 < sk; n0 += BN) {
    __syncthreads();  // previous tile fully consumed
    load_tile<D>(ks, k + kv_off, n0, BN, sk);
    load_tile<D>(vs, v + kv_off, n0, BN, sk);
    __syncthreads();

    // s = q . k^T for this warp's 16 rows and BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      const __nv_bfloat16* qa = qw + kk * 16 + 2 * t;
      a[0] = ld_u32(qa + g * kStride);
      a[1] = ld_u32(qa + (g + 8) * kStride);
      a[2] = ld_u32(qa + g * kStride + 8);
      a[3] = ld_u32(qa + (g + 8) * kStride + 8);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const __nv_bfloat16* kb = ks + (j * 8 + g) * kStride + kk * 16 + 2 * t;
        mma_16816(s[j], a, ld_u32(kb), ld_u32(kb + 8));
      }
    }

    // scale into the log2 domain, mask keys past sk, row max
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const float val = col < sk ? s[j][e] * scale_log2 : kNegInf;
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
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_run[e >> 1]);
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc += p . v; the score fragments of key tiles 2kk and 2kk+1 are the
    // A fragment of a k16 step
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_floats(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_floats(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_floats(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_floats(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vb = vs + (kk * 16 + 2 * t) * kStride + g;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vc = vb + j * 8;
        const uint32_t b0 = pack_halves(vc[0], vc[kStride]);
        const uint32_t b1 = pack_halves(vc[8 * kStride], vc[9 * kStride]);
        mma_16816(acc[j], a, b0, b1);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.f / fmaxf(l, 1e-30f);
  }
  const int row = m0 + warp * 16 + g;
  __nv_bfloat16* orow = o + q_off + static_cast<size_t>(row) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (row < sq) {
      *reinterpret_cast<uint32_t*>(orow + j * 8) =
          pack_floats(acc[j][0] * inv[0], acc[j][1] * inv[0]);
    }
    if (row + 8 < sq) {
      *reinterpret_cast<uint32_t*>(orow + 8 * D + j * 8) =
          pack_floats(acc[j][2] * inv[1], acc[j][3] * inv[1]);
    }
  }
}

template <int D, int BN>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int sq, int sk, float scale_log2,
                   cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<D, BN>();
  // The shared-memory attribute is set once per instance and device, not
  // per launch (setting it twice from two threads is harmless).
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (!bit || !(attr_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<D, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    attr_set.fetch_or(bit, std::memory_order_release);
  }
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_kernel<D, BN><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq,
      sk, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [bh, sq, dh], k/v [bh, sk, dh], o [bh, sq, dh]: contiguous bf16 device
// pointers, 16-byte aligned. scale_log2 = softmax scale * log2(e). Launches
// on `stream` without synchronising and returns the cudaError_t of the
// launch (0 on success).
int tm_flash_attention_bf16(const void* q, const void* k, const void* v,
                            void* o, int bh, int sq, int sk, int dh,
                            float scale_log2, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return launch<64, 64>(q, k, v, o, bh, sq, sk, scale_log2, s);
    case 128:
      return launch<128, 64>(q, k, v, o, bh, sq, sk, scale_log2, s);
    case 256:
      return launch<256, 32>(q, k, v, o, bh, sq, sk, scale_log2, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* tm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
