// Frame-axis (short-sequence) multi-head self-attention for Hopper (sm_90a),
// bf16 operands, fp32 scores and softmax.
//
// Replaces the Pallas TPU kernel tweediemix_tpu/ops/short_attention.py
// `_short_kernel` (wrapper `short_seq_attention`, dispatched by
// tweediemix_tpu/ops/attention.py::multi_head_attention behind
// TWEEDIEMIX_SHORT_ATTENTION=1). It computes the same function:
//
//     o[n, i, h, :] = sum_j softmax_j(q[n, i, h, :] . k[n, j, h, :] * scale) v[n, j, h, :]
//
// over q/k/v [N, S, H*dh] (bf16, any row strides with a unit last stride),
// S <= 32, dh in {32, 64, 128}: every pixel row n attends only within its own
// S frames, head by head. Frames past S are zero-filled on load and their
// scores masked, the softmax takes the row max in the log2 domain (the TPU
// kernel's +100 clamp is a no-op after that shift and is left out), the
// denominator is floored at 1e-30, and o is written in the merged
// [N, S, H*dh] layout in bf16.
//
// What bounds it on an H100: it reads q, k and v once and writes o once,
// 4*N*S*H*dh*2 bytes, against 4*N*S^2*H*dh flops: S/2 = 8 flops per byte at
// S = 16, far below the card's ~295 bf16 flops/byte. So HBM bytes are the
// limit, and the design moves each byte once:
//   * one warp per (pixel row, head) band, 4 warps per block; the band's
//     S x dh slices of q, k and v are read straight from the [N, S, H*dh]
//     tensors with their row strides (the self-attention's q/k/v are views
//     of the merged to_qkv output, so no copy and no head-major relayout --
//     the relayout that made the TPU version a loss on v5e);
//   * the loads are 16-byte cp.async copies into the warp's own shared
//     memory, all three tensors in flight at once, with the rows past S
//     zero-filled by the copy itself;
//   * q.k^T and p.v run as mma.sync.m16n8k16 bf16 -> fp32: one m16 tile of
//     frames for S <= 16, two for S <= 32; the score fragment is re-packed in
//     registers as p.v's A operand, as in csrc/flash_attention.cu;
//   * the softmax scale times log2(e) is applied to the fp32 scores (q is
//     never pre-scaled and rounded to bf16, a TPU device the port leaves
//     behind) and exp2f gives the weights.
// The TPU kernel's packing of 128/S bands into one 128-row MXU tile with a
// block-diagonal mask is not carried over: a warp's m16 tile already holds a
// whole band.
//
// C interface (loaded with ctypes): see tm_short_attention_bf16 below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF

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

// 16-byte global -> shared copy; with valid == false it reads nothing and
// writes 16 zero bytes.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            bool valid) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

// Copy one band's rows [0, SP) of dh = D values (row r at src + r * stride_s)
// into shared memory with a row stride of D + 8 elements; rows >= s are
// zero-filled.
template <int SP, int D>
__device__ __forceinline__ void load_band(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long stride_s, int s, int lane) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = lane; i < SP * kChunks; i += 32) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    const bool valid = r < s;
    cp_async_16(dst + r * (D + 8) + c, valid ? src + r * stride_s + c : src,
                valid);
  }
}

template <int SP, int D>
constexpr int smem_bytes() {
  return kWarps * 3 * SP * (D + 8) * static_cast<int>(sizeof(__nv_bfloat16));
}

// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A regs: (row g, k 2t..2t+1), (row g+8, k 2t..), (row g, k 2t+8..), (row g+8, k 2t+8..)
//   B regs: (k 2t..2t+1, col g), (k 2t+8..2t+9, col g)
//   C/D:    (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1)
// SP = S rounded up to 16 or 32; D = dh.
template <int SP, int D>
__global__ void __launch_bounds__(kThreads)
    short_attn_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, long long q_sn,
                      long long q_ss, long long k_sn, long long k_ss,
                      long long v_sn, long long v_ss, int n_rows, int s,
                      int heads, float scale_log2) {
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long band = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (band >= static_cast<long long>(n_rows) * heads) return;  // no block barrier below
  const long long n = band / heads;
  const int h = static_cast<int>(band % heads);

  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw) + warp * 3 * SP * kStride;
  __nv_bfloat16* ks = qs + SP * kStride;
  __nv_bfloat16* vs = ks + SP * kStride;
  load_band<SP, D>(qs, q + n * q_sn + h * D, q_ss, s, lane);
  load_band<SP, D>(ks, k + n * k_sn + h * D, k_ss, s, lane);
  load_band<SP, D>(vs, v + n * v_sn + h * D, v_ss, s, lane);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncwarp();

  const int g = lane >> 2;
  const int t = lane & 3;
  const int d_model = heads * D;
  __nv_bfloat16* ob = o + n * s * d_model + h * D + 2 * t;

#pragma unroll
  for (int mt = 0; mt < SP / 16; ++mt) {
    // scores of frames mt*16 .. mt*16+15 against all SP key frames
    float sc[SP / 8][4];
#pragma unroll
    for (int j = 0; j < SP / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    }
    const __nv_bfloat16* qw = qs + mt * 16 * kStride;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      const __nv_bfloat16* qa = qw + kk * 16 + 2 * t;
      a[0] = ld_u32(qa + g * kStride);
      a[1] = ld_u32(qa + (g + 8) * kStride);
      a[2] = ld_u32(qa + g * kStride + 8);
      a[3] = ld_u32(qa + (g + 8) * kStride + 8);
#pragma unroll
      for (int j = 0; j < SP / 8; ++j) {
        const __nv_bfloat16* kb = ks + (j * 8 + g) * kStride + kk * 16 + 2 * t;
        mma_16816(sc[j], a, ld_u32(kb), ld_u32(kb + 8));
      }
    }

    // scale into the log2 domain, mask key frames >= s, row max and sum
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < SP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const float val = col < s ? sc[j][e] * scale_log2 : kNegInf;
        sc[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < SP / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[j][e] - mx[e >> 1]);
        sc[j][e] = p;
        l[e >> 1] += p;
      }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-30f);
    }

    // o = p . v; the score fragments of key tiles 2kk and 2kk+1 are the A
    // fragment of a k16 step
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < SP / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_floats(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_floats(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_floats(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_floats(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const __nv_bfloat16* vb = vs + (kk * 16 + 2 * t) * kStride + g;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat16* vc = vb + j * 8;
        const uint32_t b0 = pack_halves(vc[0], vc[kStride]);
        const uint32_t b1 = pack_halves(vc[8 * kStride], vc[9 * kStride]);
        mma_16816(acc[j], a, b0, b1);
      }
    }

    // rows mt*16+g and mt*16+g+8 of the band, frames >= s dropped
    const int row = mt * 16 + g;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row < s) {
        *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row) * d_model + j * 8) =
            pack_floats(acc[j][0] * inv[0], acc[j][1] * inv[0]);
      }
      if (row + 8 < s) {
        *reinterpret_cast<uint32_t*>(ob + static_cast<long long>(row + 8) * d_model + j * 8) =
            pack_floats(acc[j][2] * inv[1], acc[j][3] * inv[1]);
      }
    }
  }
}

template <int SP, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   long long q_sn, long long q_ss, long long k_sn,
                   long long k_ss, long long v_sn, long long v_ss, int n_rows,
                   int s, int heads, float scale_log2, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<SP, D>();
  // The shared-memory attribute is set once per instance and device, not
  // per launch (setting it twice from two threads is harmless).
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (!bit || !(attr_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(short_attn_kernel<SP, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    attr_set.fetch_or(bit, std::memory_order_release);
  }
  const long long blocks =
      (static_cast<long long>(n_rows) * heads + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  short_attn_kernel<SP, D><<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), q_sn,
      q_ss, k_sn, k_ss, v_sn, v_ss, n_rows, s, heads, scale_log2);
  return cudaGetLastError();
}

template <int SP>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v,
                      void* o, long long q_sn, long long q_ss, long long k_sn,
                      long long k_ss, long long v_sn, long long v_ss,
                      int n_rows, int s, int heads, float scale_log2,
                      cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<SP, 32>(q, k, v, o, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss,
                            n_rows, s, heads, scale_log2, stream);
    case 64:
      return launch<SP, 64>(q, k, v, o, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss,
                            n_rows, s, heads, scale_log2, stream);
    case 128:
      return launch<SP, 128>(q, k, v, o, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss,
                             n_rows, s, heads, scale_log2, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q/k/v: bf16 device pointers to [n_rows, s, heads*dh] tensors with a unit
// last stride; element (n, i, c) of q at q + n*q_sn + i*q_ss + c (strides in
// elements, multiples of 8; pointers 16-byte aligned). o: contiguous bf16
// [n_rows, s, heads*dh]. scale_log2 = softmax scale * log2(e). Launches on
// `stream` without synchronising and returns the cudaError_t of the launch
// (0 on success).
int tm_short_attention_bf16(const void* q, const void* k, const void* v,
                            void* o, long long q_sn, long long q_ss,
                            long long k_sn, long long k_ss, long long v_sn,
                            long long v_ss, int n_rows, int s, int heads,
                            int dh, float scale_log2, void* stream) {
  if (n_rows < 1 || s < 1 || s > 32 || heads < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s <= 16) {
    return launch_dh<16>(dh, q, k, v, o, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss,
                         n_rows, s, heads, scale_log2, st);
  }
  return launch_dh<32>(dh, q, k, v, o, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss,
                       n_rows, s, heads, scale_log2, st);
}

const char* tm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
