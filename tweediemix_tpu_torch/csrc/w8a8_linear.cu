// W8A8 linear for Hopper (sm_90a): y = x . dequant(wq)^T (+ bias) with int8
// activations, in two launches: a one-pass int8 quantise of x, and an int8
// wgmma GEMM whose epilogue dequantises, casts and adds the bias.
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA
// (tweediemix_tpu/ops/quant.py:101-127, `w8a8_matmul`). The port ran it as
// about eleven PyTorch launches a site (cast, divide, round, clamp, int8
// cast, torch._int_mm into an int32 [M, N], fp32 cast, two multiplies, cast,
// bias), every intermediate through device memory in fp32, and a static
// scale cost a blocking host-to-device copy. This file computes what the
// plain version (ops/quant.py::w8a8_matmul_reference) computes on the card,
// bit for bit:
//
//   xs    = fl32(static_amax / 127), a float argument     (static scale)
//   xs_m  = max(max_k |x[m, k]| * fl32(1/127), 1e-12)     (dynamic, per row:
//           PyTorch divides by a Python scalar as a multiply by its reciprocal)
//   q     = clamp(rint(x / xs), -127, 127)                IEEE division, half to even
//   acc   = sum_k q[m, k] * wq[n, k]                      exact, int32
//   y     = bf16(bf16((float(acc) * xs_m) * ws_n) + b_n)  (bf16 x; fp32 x: no casts)
//
// What bounds it on an H100. At the SDXL sites (K, N) in {(640, 1920),
// (640, 640), (640, 5120), (2560, 640)} x 4096 rows a latent row and {(1280,
// 3840), (1280, 1280), (1280, 10240), (5120, 1280)} x 1024, 2.M.N.K int8
// operations at 1979 TOP/s and the bytes of x (bf16, read once), y (bf16,
// written once) and wq at 3.35 TB/s come within a factor of two of each
// other: the K = 640 sites are bound by their bytes, the wide ones by their
// operations. So the design writes y once, from the GEMM's epilogue, keeps
// every intermediate but x_q (1 byte an element, written and read back) out
// of device memory, and keeps the tensor cores fed:
//   * w8a8_int8_quant_kernel: one warp per row, 16 bytes a lane and four
//     loads in flight; a dynamic scale reads the row twice (the second read
//     from L1), a static one once; writes x_q and, dynamic, one fp32 scale
//     per row;
//   * w8a8_int8_gemm_kernel: a persistent grid (one block per SM, the tiles
//     walked M-fastest so the blocks in flight share B's panel), tiles of
//     128 rows x 160 columns (160 divides every N of the SDXL and I2VGen-XL
//     sites, and at their M the tiles come in multiples of 128, so each
//     wave fills 128 of the 132 SMs), three warpgroups: a producer
//     (registers lowered to 24) whose one thread issues the TMA loads of A
//     [128 rows][128 k] and B [160 rows][128 k], both K-major with 128-byte
//     swizzle as 8-bit wgmma requires, into an mbarrier ring of as many
//     stages as shared memory holds beside the output panels (5 in bf16, 3
//     in fp32), so the next tile's loads run during a tile's epilogue; two
//     consumers of 64 rows each issue wgmma m64n160k32 .s32.s8.s8 from shared
//     memory, one k tile in flight behind the next. A tile's column scales, bias and row scales are fetched
//     before its products and staged in shared memory, so that no global
//     load's latency stands in the epilogue's unrolled loop. The epilogue
//     converts the int32 sums in registers, writes them as 32-column panels
//     (64-byte swizzle in bf16, 128-byte in fp32: no bank conflicts) and
//     stores each panel with TMA, rows past M and columns past N clipped;
//     ragged M, N and K read TMA's zero fill.
//
// C interface (loaded with ctypes): see the extern "C" block below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 2;             // consumer warpgroups of 64 rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBlockM = 64 * kConsumers;  // rows of x per tile
constexpr int kBlockN = 160;              // columns of y per tile
constexpr int kBlockK = 128;              // int8 k per stage: one 128-byte swizzled row
constexpr int kMaxStages = 8;
constexpr int kProducerRegs = 24;         // setmaxnreg: 128 * (24 + 2 * 240) <= 65536
constexpr int kConsumerRegs = 240;
constexpr int kPanelCols = 32;            // output columns of one TMA store box
constexpr int kSmemLimit = 232448;

// The GEMM's layout for output element T.
template <typename T_>
struct Cfg {
  using T = T_;
  static constexpr int BN = kBlockN;
  static constexpr int kABytes = kBlockM * kBlockK;
  static constexpr int kBBytes = BN * kBlockK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kRowBytes = kPanelCols * static_cast<int>(sizeof(T));  // 64 or 128
  static constexpr int kPanelBytes = 64 * kRowBytes;  // one consumer's store box
  static constexpr int kPanels = BN / kPanelCols;
  static constexpr int kOutBytes = kConsumers * kPanels * kPanelBytes;
  static constexpr int kColBytes = 8 * BN;  // a consumer's column scales and bias, as floats
  static constexpr int kFit =
      (kSmemLimit - 1024 - kOutBytes - kConsumers * kColBytes - 16 * kMaxStages) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kColOffset = kStages * kStageBytes + kOutBytes;
  static constexpr int kBarOffset = kColOffset + kConsumers * kColBytes;
  // 2 mbarriers a stage, + 1024 to align the base for the swizzle
  static constexpr int kSmemBytes = kBarOffset + 16 * kStages + 1024;
  static_assert(BN % kPanelCols == 0, "tile width");
  static_assert(kStages >= 2, "the ring needs two stages");
  static_assert(kStageBytes % 1024 == 0 && kPanelBytes % 1024 == 0, "swizzle alignment");
  static_assert(kSmemBytes <= kSmemLimit, "shared memory");
};

// The bias of columns col, col + 1 as floats.
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Columns 8j + 2t, 8j + 2t + 1 of local row lr into this consumer's output
// panels (panel j / 4): the product cast to bf16, then the bias added and
// cast again, as PyTorch rounds `y.to(bf16) + bias`. 64-byte swizzle: the
// 16-byte chunk index is XORed with bits 7-8 of the offset, (lr / 2) % 4.
__device__ __forceinline__ void store_pair(unsigned char* out, int lr, int j, int t, float v0,
                                           float v1, float2 b, bool has_bias, __nv_bfloat16) {
  __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
  if (has_bias) {
    const float2 f = __bfloat1622float2(y);
    y = __floats2bfloat162_rn(__fadd_rn(f.x, b.x), __fadd_rn(f.y, b.y));
  }
  const int chunk = (j % 4) ^ ((lr >> 1) & 3);
  *reinterpret_cast<__nv_bfloat162*>(out + (j / 4) * (64 * 64) + lr * 64 + chunk * 16 + 4 * t) = y;
}

// The same in fp32 (128-byte swizzle: the chunk index XORed with lr % 8).
__device__ __forceinline__ void store_pair(unsigned char* out, int lr, int j, int t, float v0,
                                           float v1, float2 b, bool has_bias, float) {
  const float2 y = has_bias ? make_float2(__fadd_rn(v0, b.x), __fadd_rn(v1, b.y))
                            : make_float2(v0, v1);
  const int chunk = (2 * (j % 4) + t / 2) ^ (lr & 7);
  *reinterpret_cast<float2*>(out + (j / 4) * (64 * 128) + lr * 128 + chunk * 16 + 8 * (t % 2)) = y;
}

// What a consumer thread fetches for a tile before its products, so that the
// loads run under them: the weight scales and bias of columns n0 + 2 tid,
// + 1 (tid < BN / 2), and the activation scales of its two rows.
struct TileScales {
  float2 ws, b;
  float xs0, xs1;
};

template <class C>
__device__ __forceinline__ TileScales fetch_scales(const float* __restrict__ wscale,
                                                   const typename C::T* __restrict__ bias,
                                                   const float* __restrict__ xrow, float xscale,
                                                   int m, int n, int m0, int n0, int c) {
  const int tid = threadIdx.x % 128;
  TileScales f{make_float2(0.f, 0.f), make_float2(0.f, 0.f), xscale, xscale};
  const int col = n0 + 2 * tid;
  if (2 * tid < C::BN && col < n) {  // n is a multiple of 16: col + 1 < n too
    f.ws = *reinterpret_cast<const float2*>(wscale + col);
    if (bias != nullptr) f.b = load_pair(bias + col);
  }
  if (xrow != nullptr) {
    const int r = m0 + c * 64 + (tid / 32) * 16 + (tid % 32) / 4;
    f.xs0 = r < m ? xrow[r] : 0.f;
    f.xs1 = r + 8 < m ? xrow[r + 8] : 0.f;
  }
  return f;
}

// y[m0 + 64c .. +64, n0 .. n0 + BN) from this consumer's sums. Accumulator
// layout of wgmma m64nN (warp w of the warpgroup, g = lane / 4, t = lane %
// 4): acc[4j + e] is row 16w + g + 8 (e >> 1), column 8j + 2t + (e & 1). The
// column scales and bias go through this consumer's `cols` in shared memory
// (as float2 pairs: scales, then bias), read back at the column each value
// needs.
template <class C>
__device__ __forceinline__ void epilogue(const int (&acc)[C::BN / 2], unsigned char* out,
                                         float2* cols, const CUtensorMap* ty,
                                         const TileScales& f, bool has_bias, int m, int n, int m0,
                                         int n0, int c) {
  const int tid = threadIdx.x % 128;
  const int lr = (tid / 32) * 16 + (tid % 32) / 4;  // local rows lr and lr + 8
  const int t = tid % 4;
  if (2 * tid < C::BN) {
    cols[tid] = f.ws;
    cols[C::BN / 2 + tid] = f.b;
  }
  // the previous tile's stores have read this consumer's panels
  if (tid == 0) bulk_wait_group_read<0>();
  named_bar_sync(1 + c, 128);
#pragma unroll
  for (int j = 0; j < C::BN / 8; ++j) {
    const float2 ws = cols[4 * j + t], b = cols[C::BN / 2 + 4 * j + t];
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + e]), e < 2 ? f.xs0 : f.xs1),
                       (e & 1) ? ws.y : ws.x);
    }
    store_pair(out, lr, j, t, v[0], v[1], b, has_bias, typename C::T{});
    store_pair(out, lr + 8, j, t, v[2], v[3], b, has_bias, typename C::T{});
  }
  fence_proxy_async_shared();  // the panels are read next by the TMA unit
  named_bar_sync(1 + c, 128);
  if (tid == 0 && m0 + c * 64 < m) {
#pragma unroll
    for (int p = 0; p < C::kPanels; ++p) {
      if (n0 + p * kPanelCols < n) {
        tma_store_2d(ty, out + p * C::kPanelBytes, n0 + p * kPanelCols, m0 + c * 64);
      }
    }
    bulk_commit_group();
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads, 1)
    w8a8_int8_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb,
                          const __grid_constant__ CUtensorMap ty,
                          const float* __restrict__ wscale, const typename C::T* __restrict__ bias,
                          const float* __restrict__ xrow, float xscale, int m, int n, int k) {
  constexpr int BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* out_smem = smem + C::kStages * C::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kBarOffset);
  uint64_t* empty = full + C::kStages;

  const int m_tiles = (m + kBlockM - 1) / kBlockM;
  const int tiles = m_tiles * ((n + BN - 1) / BN);
  const int k_tiles = (k + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 128 * kConsumers);  // every consumer thread releases a stage
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&ta);
      tma_prefetch_map(&tb);
      int st = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % m_tiles) * kBlockM, n0 = (tile / m_tiles) * BN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[st], phase ^ 1);  // the first round passes at once
          unsigned char* a = smem + st * C::kStageBytes;
          mbar_arrive_expect_tx(&full[st], C::kStageBytes);
          tma_load_2d(a, &ta, &full[st], kt * kBlockK, m0);
          tma_load_2d(a + C::kABytes, &tb, &full[st], kt * kBlockK, n0);
          if (++st == C::kStages) {
            st = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups of 64 rows each ----
    setmaxnreg_inc<kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1;
    unsigned char* out = out_smem + c * C::kPanels * C::kPanelBytes;
    float2* cols = reinterpret_cast<float2*>(smem + C::kColOffset + c * C::kColBytes);
    const uint32_t stage0 = smem_u32(smem);
    if (threadIdx.x % 128 == 0) tma_prefetch_map(&ty);
    int acc[BN / 2];
    int st = 0, prev = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % m_tiles) * kBlockM, n0 = (tile / m_tiles) * BN;
      const TileScales f = fetch_scales<C>(wscale, bias, xrow, xscale, m, n, m0, n0, c);
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[st], phase);
        const uint32_t a_addr = stage0 + st * C::kStageBytes;
        const uint64_t da = desc_kmajor(a_addr + c * 64 * kBlockK, kBlockK);
        const uint64_t db = desc_kmajor(a_addr + C::kABytes, kBlockK);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockK / 32; ++kk) {
          wgmma_s8_ss_m64n160(acc, desc_advance(da, kk * 32), desc_advance(db, kk * 32),
                              kt > 0 || kk > 0);
        }
        wgmma_commit();
        if (kt > 0) {
          wgmma_wait<1>();  // k tile kt - 1 done: its stage is free
          mbar_arrive(&empty[prev]);
        }
        prev = st;
        if (++st == C::kStages) {
          st = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[prev]);
      epilogue<C>(acc, out, cols, &ty, f, bias != nullptr, m, n, m0, n0, c);
    }
    if (threadIdx.x % 128 == 0) bulk_wait_group<0>();
  }
}

template <class C>
cudaError_t launch_gemm(const void* xq, const void* wq, const void* wscale, const void* bias,
                        const float* xrow, void* y, float xscale, int m, int n, int k, int grid,
                        cudaStream_t stream) {
  using T = typename C::T;
  // The shared-memory attribute is set once per instance and device.
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (!bit || !(attr_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(w8a8_int8_gemm_kernel<C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
    if (err != cudaSuccess) return err;
    attr_set.fetch_or(bit, std::memory_order_release);
  }
  constexpr CUtensorMapDataType kOut =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapSwizzle kOutSwizzle =
      C::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap ta, tb, ty;
  if (!encode_2d(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, m, k, k, kBlockM, kBlockK,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, wq, n, k, k, C::BN, kBlockK,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&ty, kOut, y, m, n, static_cast<uint64_t>(n) * sizeof(T), 64, kPanelCols,
                 kOutSwizzle)) {
    return cudaErrorInvalidValue;
  }
  w8a8_int8_gemm_kernel<C><<<grid, kThreads, C::kSmemBytes, stream>>>(
      ta, tb, ty, static_cast<const float*>(wscale), static_cast<const T*>(bias), xrow, xscale, m,
      n, k);
  return cudaGetLastError();
}

// ---- the quantise --------------------------------------------------------

constexpr int kQuantThreads = 256;  // 8 warps, one row each
constexpr int kQuantRows = kQuantThreads / 32;

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint32_t quantize4(const float* f, float s) {
  uint32_t out = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int q = static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(f[e], s)), -127.f), 127.f));
    out |= (static_cast<uint32_t>(q) & 0xffu) << (8 * e);
  }
  return out;
}

__device__ __forceinline__ void store_q(int8_t* dst, const float (&f)[8], float s) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(quantize4(f, s), quantize4(f + 4, s));
}

__device__ __forceinline__ void store_q(int8_t* dst, const float (&f)[4], float s) {
  *reinterpret_cast<uint32_t*>(dst) = quantize4(f, s);
}

// x [m, k] (T: bf16 or fp32, rows 16-byte aligned) -> xq [m, k] int8 and,
// when xrow is not null, the rows' dynamic scales; else every row takes
// xscale.
template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    w8a8_int8_quant_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                           float* __restrict__ xrow, float xscale, int m, int k) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const int chunks = k / kVec;
  for (int row = blockIdx.x * kQuantRows + threadIdx.x / 32; row < m;
       row += gridDim.x * kQuantRows) {
    const uint4* src = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * k);
    int8_t* dst = xq + static_cast<size_t>(row) * k;
    float s = xscale;
    if (xrow != nullptr) {
      float amax = 0.f;
#pragma unroll 4
      for (int i = lane; i < chunks; i += 32) {
        float f[kVec];
        unpack(src[i], f);
#pragma unroll
        for (int e = 0; e < kVec; ++e) amax = fmaxf(amax, fabsf(f[e]));
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      }
      s = fmaxf(__fmul_rn(amax, __fdiv_rn(1.f, 127.f)), 1e-12f);
      if (lane == 0) xrow[row] = s;
    }
#pragma unroll 4
    for (int i = lane; i < chunks; i += 32) {
      float f[kVec];
      unpack(src[i], f);
      store_q(dst + i * kVec, f, s);
    }
  }
}

template <typename T>
cudaError_t linear_as(const void* x, const void* wq, const void* wscale, const void* bias,
                      void* xq, float* xrow, void* y, int m, int n, int k, float xscale, int grid,
                      cudaStream_t stream) {
  const int blocks = (m + kQuantRows - 1) / kQuantRows;
  w8a8_int8_quant_kernel<T><<<blocks, kQuantThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(xq), xrow, xscale, m, k);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gemm<Cfg<T>>(xq, wq, wscale, bias, xrow, y, xscale, m, n, k, grid, stream);
}

}  // namespace

extern "C" {

// y [m, n] = x [m, k] . dequant(wq [n, k])^T (+ bias [n]) in two launches on
// `stream`, without synchronising. plan: {m, n, k, dtype, grid} as int32
// (made once per site shape): dtype 0 (bf16) or 1 (fp32) for x, y and the
// bias; grid the persistent GEMM's blocks, at most its tiles of 128 x 160;
// k and n multiples of 16. x contiguous and 16-byte aligned; wq int8 [n, k]
// and wscale fp32 [n] contiguous; bias [n] or null. work: the quantised x_q
// int8 [m, k] and, for a dynamic scale (xscale = 0), the rows' fp32 scales
// [m] at byte 16 * ceil(m * k / 16); xscale > 0 is the static scale
// static_amax / 127. Returns a cudaError_t (0 on success).
int tm_w8a8_linear(const int* plan, const void* x, const void* wq, const void* wscale,
                   const void* bias, void* work, void* y, float xscale, void* stream) {
  const int m = plan[0], n = plan[1], k = plan[2], dtype = plan[3], grid = plan[4];
  if (m < 1 || n < 16 || k < 16 || n % 16 || k % 16 || grid < 1 || !(xscale >= 0.f)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t xq_bytes = (static_cast<size_t>(m) * k + 15) / 16 * 16;
  float* rows =
      xscale > 0.f ? nullptr : reinterpret_cast<float*>(static_cast<char*>(work) + xq_bytes);
  if (dtype == 0) {
    return linear_as<__nv_bfloat16>(x, wq, wscale, bias, work, rows, y, m, n, k, xscale, grid, s);
  }
  if (dtype == 1) {
    return linear_as<float>(x, wq, wscale, bias, work, rows, y, m, n, k, xscale, grid, s);
  }
  return cudaErrorInvalidValue;
}

const char* tm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
