// GroupNorm with an optional SiLU for Hopper (sm_90a), in one launch:
//
//   y = x * (rstd * gamma_c) + (beta_c - mean * rstd * gamma_c),  then y * sigmoid(y) if silu
//
// over a contiguous [N, C, *spatial] tensor, with the mean and the biased
// variance of each (sample, group) row of (C / G) * S elements, rstd =
// rsqrt(var + eps) as in F.group_norm, everything in fp32 and one rounding
// to x's type at the store.
//
// Replaces no Pallas kernel: the JAX package leaves nn.GroupNorm to XLA
// (tweediemix_tpu/models/unet2d.py:363,398,405,580, unet3d.py:159). The
// port ran PyTorch's four launches a site: the statistics kernel (one
// 512-thread block a row, scalar 2-byte loads, a Welford division an
// element), the fused parameters, the a*x + b pass and, at most sites, a
// separate SiLU pass that reads and writes the tensor again.
//
// What bounds it on an H100: bytes. x read once, y written once, gamma and
// beta at 3.35 TB/s; a handful of flops an element. The video UNet's
// temporal norms give 64 rows of up to 10 * 16 * 4096 elements (1.3 MB),
// its spatial ones 1024 rows, the SDXL UNet 64 or 128 rows of up to 983 KB.
// So the design:
//   * each row is split over a thread block cluster of `cluster` blocks
//     (1-16, chosen by ops/group_norm.py::launch_plan from the row count,
//     the row length and the SM count), so 64 rows fill the card as 1024 do,
//     each block's share of a row small enough that two to four blocks share
//     an SM and one block's loads overlap another's stores;
//   * where a block's chunk of the row fits its shared memory (every row of
//     the two UNets' main paths), one thread loads it with 1-D bulk copies,
//     one mbarrier per piece, so the statistics of a piece start while the
//     later pieces arrive, and the normalise pass reads it from shared
//     memory: x crosses from device memory once. Otherwise the chunk is
//     streamed twice with 16-byte loads (the second read mostly from L2);
//   * each thread folds 16-byte vectors into (count, mean, M2), merged with
//     Chan's formula through the warp, the block and, through distributed
//     shared memory, the cluster: no sum of squares, which cancels at rows
//     of 655k elements with a mean far from zero. Every block of a cluster
//     merges the partials in the same order and gets the same statistics;
//   * the normalise pass stores 16-byte vectors of y; a vector never spans
//     two channels (S is a multiple of the vector).
// Unaligned tensors (S not a multiple of 16 bytes of x, or x not 16-byte
// aligned) take scalar loads and the two-read path.
//
// C interface (loaded with ctypes): see the extern "C" block below.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxPieces = 16;         // mbarriers: bulk-copy pieces of one chunk
constexpr int kMaxCluster = 16;        // past 8 a non-portable cluster size
constexpr int kMaxThreads = 256;
constexpr int kOneReadBlocksPerSm = 8; // registers for eight blocks of kMaxThreads an SM
constexpr int kMaxDynamicSmem = 231424;  // 227 KB a block, less 1 KB for the static arrays

struct Params {
  const void* x;
  void* y;
  const void* gamma;
  const void* beta;
  int gamma_kind, beta_kind;  // 0 none, 1 bf16, 2 fp16, 3 fp32
  int row_len;                // (C / G) * S elements
  int spatial;                // S
  int cpg;                    // channels a group
  uint32_t s_magic, s_shift;  // n / S as (umulhi(n, s_magic) + n) >> s_shift
  int groups;
  int chunk;                  // elements a block, a multiple of the vector
  int pieces;                 // bulk copies a chunk (one-read path)
  float eps;
  int silu;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}

// VEC elements, loaded and stored as one access of VEC * sizeof(T) bytes
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// n / S for n < 2^31: a multiply and a shift (Granlund and Montgomery)
__device__ __forceinline__ int div_spatial(const Params& p, int n) {
  return static_cast<int>((__umulhi(static_cast<uint32_t>(n), p.s_magic) + n) >> p.s_shift);
}

__device__ __forceinline__ float load_param(const void* p, int i, int kind, float none) {
  switch (kind) {
    case 1:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case 2:
      return __half2float(static_cast<const __half*>(p)[i]);
    case 3:
      return static_cast<const float*>(p)[i];
    default:
      return none;
  }
}

struct Stats {
  float n, mean, m2;
};

// a += b, Chan's pairwise update of (count, mean, M2)
__device__ __forceinline__ void merge(Stats& a, const Stats& b) {
  const float n = a.n + b.n;
  if (n == 0.f) return;
  const float wb = __fdividef(b.n, n);
  const float d = b.mean - a.mean;
  a.mean = fmaf(d, wb, a.mean);
  a.m2 += b.m2 + d * d * a.n * wb;
  a.n = n;
}

// One vector into a thread's running statistics: its own mean and M2 (two
// passes over registers), then Chan's update.
template <typename T, int VEC>
__device__ __forceinline__ void accumulate(Stats& s, const Pack<T, VEC>& p) {
  float v[VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    v[i] = to_f32(p.v[i]);
    sum += v[i];
  }
  const float m = sum * (1.f / VEC);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float d = v[i] - m;
    q = fmaf(d, d, q);
  }
  const float n = s.n + VEC;
  const float wb = __fdividef(static_cast<float>(VEC), n);
  const float d = m - s.mean;
  s.mean = fmaf(d, wb, s.mean);
  s.m2 += q + d * d * s.n * wb;
  s.n = n;
}

// Lane 0 gets the warp's statistics.
__device__ __forceinline__ Stats warp_reduce(Stats s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Stats o{__shfl_down_sync(0xffffffffu, s.n, off), __shfl_down_sync(0xffffffffu, s.mean, off),
                  __shfl_down_sync(0xffffffffu, s.m2, off)};
    merge(s, o);
  }
  return s;
}

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> normalise(const Pack<T, VEC>& a, float scale, float shift,
                                                  bool silu) {
  Pack<T, VEC> o;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float f = fmaf(to_f32(a.v[i]), scale, shift);
    // f * sigmoid(f); the reciprocal of an infinite 1 + e^-f is 0
    if (silu) f *= __fdividef(1.f, 1.f + __expf(-f));
    o.v[i] = from_f32<T>(f);
  }
  return o;
}

// Grid: rows * cluster blocks, clusters of `cluster` along x; cluster c
// normalises row c (sample c / G, group c % G), its block r the elements
// [r * chunk, (r + 1) * chunk) of that row.
template <typename T, int VEC, bool kOneRead>
__global__ void __launch_bounds__(kMaxThreads, kOneRead ? kOneReadBlocksPerSm : 1)
    group_norm_kernel(const Params p) {
  using P = Pack<T, VEC>;
  const uint32_t cluster = cluster_nctarank();
  const uint32_t rank = cluster_ctarank();
  const long long row = blockIdx.x / cluster;
  const int start = static_cast<int>(rank) * p.chunk;
  const int count = max(0, min(p.chunk, p.row_len - start));
  const int nvec = count / VEC;
  const long long base = row * p.row_len + start;
  const P* xs = reinterpret_cast<const P*>(static_cast<const T*>(p.x) + base);
  P* ys = reinterpret_cast<P*>(static_cast<T*>(p.y) + base);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  const int buf_bytes = kOneRead ? (p.chunk * static_cast<int>(sizeof(T)) + 15) / 16 * 16 : 0;
  P* buf = reinterpret_cast<P*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + buf_bytes);
  float* scale_s = reinterpret_cast<float*>(bars + kMaxPieces);
  float* shift_s = scale_s + p.cpg;
  __shared__ float red[3 * kMaxThreads / 32];
  __shared__ float part[3];  // this block's statistics, read by the whole cluster
  __shared__ float stat[2];  // the row's mean and rstd

  Stats s{0.f, 0.f, 0.f};
  if constexpr (kOneRead) {
    const int per_piece = (nvec + p.pieces - 1) / p.pieces;
    if (tid == 0) {
      for (int i = 0; i < p.pieces; ++i) mbar_init(&bars[i], 1);
      mbar_fence_init();
    }
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < p.pieces; ++i) {
        const int v0 = i * per_piece;
        const int nv = max(0, min(per_piece, nvec - v0));
        if (nv > 0) {
          const uint32_t bytes = static_cast<uint32_t>(nv) * sizeof(P);
          mbar_arrive_expect_tx(&bars[i], bytes);
          bulk_load(buf + v0, xs + v0, bytes, &bars[i]);
        } else {
          mbar_arrive(&bars[i]);
        }
      }
    }
    for (int i = 0; i < p.pieces; ++i) {
      const int v1 = min(nvec, (i + 1) * per_piece);
      mbar_wait(&bars[i], 0);
#pragma unroll 4
      for (int v = i * per_piece + tid; v < v1; v += nt) accumulate<T, VEC>(s, buf[v]);
    }
  } else {
    int v = tid;
    for (; v + 3 * nt < nvec; v += 4 * nt) {  // four loads in flight
      P a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = xs[v + u * nt];
#pragma unroll
      for (int u = 0; u < 4; ++u) accumulate<T, VEC>(s, a[u]);
    }
    for (; v < nvec; v += nt) accumulate<T, VEC>(s, xs[v]);
  }

  s = warp_reduce(s);
  if (lane == 0) {
    red[3 * warp] = s.n;
    red[3 * warp + 1] = s.mean;
    red[3 * warp + 2] = s.m2;
  }
  __syncthreads();
  if (warp == 0) {
    Stats w{0.f, 0.f, 0.f};
    if (lane < nt / 32) w = Stats{red[3 * lane], red[3 * lane + 1], red[3 * lane + 2]};
    w = warp_reduce(w);
    if (lane == 0) {
      part[0] = w.n;
      part[1] = w.mean;
      part[2] = w.m2;
    }
  }
  cluster_arrive();  // every block's `part` is written
  cluster_wait();
  if (warp == 0) {
    Stats c{0.f, 0.f, 0.f};
    if (static_cast<uint32_t>(lane) < cluster) {
      c = Stats{ld_cluster_f32(&part[0], lane), ld_cluster_f32(&part[1], lane),
                ld_cluster_f32(&part[2], lane)};
    }
    c = warp_reduce(c);
    if (lane == 0) {
      stat[0] = c.mean;
      stat[1] = rsqrtf(fmaxf(c.m2 / static_cast<float>(p.row_len), 0.f) + p.eps);
    }
  }
  cluster_arrive();  // this block has read the others' `part`; waited on before exit
  __syncthreads();

  // the channels this chunk touches: scale and shift of each
  const int c_first = div_spatial(p, start);
  const int nch = count > 0 ? div_spatial(p, start + count - 1) - c_first + 1 : 0;
  const int ch0 = static_cast<int>(row % p.groups) * p.cpg + c_first;
  for (int c = tid; c < nch; c += nt) {
    const float sc = stat[1] * load_param(p.gamma, ch0 + c, p.gamma_kind, 1.f);
    scale_s[c] = sc;
    shift_s[c] = fmaf(-sc, stat[0], load_param(p.beta, ch0 + c, p.beta_kind, 0.f));
  }
  __syncthreads();

  const bool silu = p.silu != 0;
  if constexpr (kOneRead) {
#pragma unroll 4
    for (int v = tid; v < nvec; v += nt) {
      const int c = div_spatial(p, start + v * VEC) - c_first;
      ys[v] = normalise<T, VEC>(buf[v], scale_s[c], shift_s[c], silu);
    }
  } else {
    int v = tid;
    for (; v + 3 * nt < nvec; v += 4 * nt) {
      P a[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = xs[v + u * nt];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = div_spatial(p, start + (v + u * nt) * VEC) - c_first;
        ys[v + u * nt] = normalise<T, VEC>(a[u], scale_s[c], shift_s[c], silu);
      }
    }
    for (; v < nvec; v += nt) {
      const int c = div_spatial(p, start + v * VEC) - c_first;
      ys[v] = normalise<T, VEC>(xs[v], scale_s[c], shift_s[c], silu);
    }
  }
  cluster_wait();  // no block leaves while another may still read its `part`
}

long long smem_bytes(int chunk, int itemsize, int cpg, bool one_read) {
  const long long buf = one_read ? (static_cast<long long>(chunk) * itemsize + 15) / 16 * 16 : 0;
  return buf + 8LL * kMaxPieces + 8LL * cpg;
}

template <typename T, int VEC, bool kOneRead>
cudaError_t launch(const Params& p, long long rows, int cluster, int threads, cudaStream_t stream) {
  static std::atomic<uint64_t> attr_set{0};
  auto kernel = group_norm_kernel<T, VEC, kOneRead>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (!bit || !(attr_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynamicSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    attr_set.fetch_or(bit, std::memory_order_release);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * cluster), 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes(p.chunk, sizeof(T), p.cpg, kOneRead));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, long long rows, int cluster, int threads, int vec,
                     bool one_read, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec == kVec) {
    return one_read ? launch<T, kVec, true>(p, rows, cluster, threads, stream)
                    : launch<T, kVec, false>(p, rows, cluster, threads, stream);
  }
  if (vec == 1 && !one_read) return launch<T, 1, false>(p, rows, cluster, threads, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, y: contiguous [rows / groups, groups * cpg, spatial] tensors of one type
// (dtype 0 bf16, 1 fp16, 2 fp32), y not overlapping x; gamma, beta: [groups
// * cpg] of their own kind (0 none: 1 and 0, 1 bf16, 2 fp16, 3 fp32). The
// plan (ops/group_norm.py::launch_plan): `cluster` blocks a row (1, 2, 4, 8
// or 16) of `threads` threads (128 or 256), `chunk` elements a block (a
// multiple of `vec`; cluster * chunk >= the row), `vec` 16 bytes of
// elements (x 16-byte aligned, spatial a multiple of it) or 1, `one_read`
// (the chunk staged in shared memory by `pieces` bulk copies, vec > 1).
// Launches on `stream` without synchronising and returns the cudaError_t of
// the launch (0 on success).
int tm_group_norm(const void* x, void* y, const void* gamma, const void* beta, int gamma_kind,
                  int beta_kind, int dtype, long long rows, int row_len, int spatial, int cpg,
                  int groups, float eps, int silu, int cluster, int threads, int chunk, int vec,
                  int one_read, int pieces, void* stream) {
  const int itemsize = dtype == 2 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || rows < 1 || row_len < 1 || spatial < 1 || cpg < 1 || groups < 1 ||
      static_cast<long long>(cpg) * spatial != row_len || rows % groups || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) || threads < 32 || threads > kMaxThreads ||
      threads % 32 || chunk < 1 || vec < 1 || chunk % vec || spatial % vec ||
      static_cast<long long>(chunk) * cluster < row_len || rows * cluster > INT_MAX ||
      pieces < 1 || pieces > kMaxPieces || (one_read && vec == 1) || gamma_kind < 0 ||
      gamma_kind > 3 || beta_kind < 0 || beta_kind > 3 ||
      smem_bytes(chunk, itemsize, cpg, one_read != 0) > kMaxDynamicSmem) {
    return cudaErrorInvalidValue;
  }
  uint32_t shift = 0;
  while (shift < 32 && (1u << shift) < static_cast<uint32_t>(spatial)) ++shift;
  const uint64_t magic = ((uint64_t{1} << 32) * ((uint64_t{1} << shift) - spatial)) / spatial + 1;
  const Params p{x, y, gamma, beta, gamma_kind, beta_kind, row_len, spatial, cpg,
                 static_cast<uint32_t>(magic), shift, groups, chunk, pieces, eps, silu};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<__nv_bfloat16>(p, rows, cluster, threads, vec, one_read != 0, s);
    case 1:
      return dispatch<__half>(p, rows, cluster, threads, vec, one_read != 0, s);
    default:
      return dispatch<float>(p, rows, cluster, threads, vec, one_read != 0, s);
  }
}

// The dynamic shared memory of a block, as the kernel lays it out (the
// wrapper's plan must agree): the chunk (one-read path, 16-byte rounded),
// kMaxPieces mbarriers, a scale and a shift a channel of the group.
long long tm_group_norm_smem_bytes(int chunk, int itemsize, int cpg, int one_read) {
  return smem_bytes(chunk, itemsize, cpg, one_read != 0);
}

const char* tm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
