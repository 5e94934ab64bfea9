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
// S frames, head by head (a "band" is one (n, h)). Frames past S read as
// zeros and their scores are masked, the softmax takes the row max in the
// log2 domain (the TPU kernel's +100 clamp is a no-op after that shift and is
// left out), the denominator is floored at 1e-30, and o is written in the
// merged [N, S, H*dh] layout in bf16.
//
// What bounds it on an H100: it reads q, k and v once and writes o once,
// 4*N*S*H*dh*2 bytes, against 4*N*S^2*H*dh flops: S/2 = 8 flops per byte at
// S = 16, far below the card's ~295 bf16 flops/byte. So HBM bytes are the
// limit, and the design keeps HBM busy and moves each byte once, in whole
// 128-byte lines:
//   * TMA loads through 4-D tensor maps over [dh, H, S, N] (innermost first)
//     with the views' own byte strides, so the self-attention's q/k/v, which
//     are chunk(3) views of the merged to_qkv output, are read in place with
//     no copy and no head-major relayout. One box is [dh panel, 1 head, 16
//     or 32 frames, R pixel rows]: a tile of R whole bands of one head, a
//     band's frames on consecutive lines (a box of several heads would put
//     them that many lines apart, and an even count makes ldmatrix's eight
//     rows share banks). dh 64 boxes are 128-byte rows with 128-byte
//     swizzle, dh 128 two such panels, dh 32 64-byte rows with 64-byte
//     swizzle, so that ldmatrix reads them without bank conflicts. TMA's
//     zero fill stands in for frames past S and rows past N (the frames'
//     scores are still masked: a zero key scores 0, not -inf);
//   * a persistent grid (the wrapper sizes it from the SM count, see
//     ops/short_attention.py::tile_plan) whose blocks walk the tiles, heads
//     fastest, so that the blocks in flight cover whole pixel rows;
//   * in each block one producer thread keeps the tiles' loads in flight in
//     a ring of stages: a `full` mbarrier counted in bytes hands a stage to
//     its consumer warp and an `empty` mbarrier hands it back. Tile i of a
//     block goes to consumer warp i % 4 and stage i % stages (stages is a
//     multiple of 4, so a stage always has the same consumer). One tile's
//     softmax and store overlap the next tiles' loads, and on the small
//     shapes every SM gets tiles;
//   * each consumer warp takes a band at a time: q.k^T and p.v as
//     mma.sync.m16n8k16 bf16 -> fp32, A and B from ldmatrix (.trans for v),
//     one m16 tile of frames for S <= 16, two for S <= 32; the score
//     fragment is re-packed in registers as p.v's A operand; the softmax
//     scale times log2(e) is applied to the fp32 scores and exp2f gives the
//     weights;
//   * TMA stores: the warp writes the normalised bf16 tile with stmatrix into
//     one of its two output buffers (the loads' swizzled layout), fences it
//     for the async proxy and one lane stores the box to the merged output;
//     TMA clips frames past S and the ragged N edge. The lane waits
//     for a buffer's previous store to finish reading before it is rewritten
//     (bulk groups).
// Why mma.sync and not wgmma: wgmma's 64-row tile would pack 4 bands (S = 16)
// or 2 (S = 32) under a block-diagonal mask and do 4x or 2x the products
// (the TPU kernel's MXU packing); at 8 flops per byte the tensor cores are
// nowhere near the bound, so mma.sync's m16 tile, which holds one band's
// frames exactly, does the least work and keeps the kernel simple.
//
// C interface (loaded with ctypes): see tm_short_attention_bf16 below.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kConsumers = 4;                    // consumer warps per block
constexpr int kThreads = 32 * (kConsumers + 1);  // and one producer warp
constexpr int kMaxSmem = 232448;                 // sm_90's opt-in limit per block
constexpr float kNegInf = -1e30f;                // the TPU kernel's NEG_INF

// Shared-memory geometry of one configuration: S padded to SP frames, head
// dim D split into panels of P elements (one box row: 128 bytes with
// 128-byte swizzle, or 64 bytes with 64-byte swizzle at D = 32).
template <int SP, int D>
struct Geom {
  static constexpr int P = D < 64 ? D : 64;
  static constexpr int kPanels = D / P;
  static constexpr int kLineBytes = P * 2;
};

// The byte offset `off` (from a 1024-byte aligned panel) as TMA's swizzle
// places it: the 16-byte chunk index XOR the 128-byte line index (bits 7-9
// for 128-byte rows, bits 7-8 for 64-byte rows).
template <int P>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return P == 64 ? off ^ ((off >> 3) & 0x70u) : off ^ ((off >> 3) & 0x30u);
}

// Shared address of 16-byte chunk `chunk` (over the whole head dim) of frame
// `frame` of a band whose frame f sits on line line0 + f of each panel.
template <int SP, int D>
__device__ __forceinline__ uint32_t chunk_addr(uint32_t base, uint32_t panel_bytes, int line0,
                                               int frame, int chunk) {
  using G = Geom<SP, D>;
  constexpr int kChunks = G::P / 8;  // 16-byte chunks per panel line
  return base + (chunk / kChunks) * panel_bytes +
         swz<G::P>((line0 + frame) * G::kLineBytes + (chunk % kChunks) * 16);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// d += a (16x16, row-major) * b (16x8, column-major); bf16 in, fp32 out.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One band, by one warp: q, k and v of the stage at qb, kb, vb, o to the
// same lines of the output buffer at ob.
//
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A regs: (row g, k 2t..2t+1), (row g+8, k 2t..), (row g, k 2t+8..), (row g+8, k 2t+8..)
//   B regs: (k 2t..2t+1, col g), (k 2t+8..2t+9, col g)
//   C/D:    (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1)
// ldmatrix.x4 gives register i the 8x8 matrix whose rows lanes 8i..8i+7
// address; stmatrix.x4 stores them the same way.
template <int SP, int D>
__device__ __forceinline__ void band(uint32_t qb, uint32_t kb, uint32_t vb, uint32_t ob,
                                     uint32_t panel_bytes, int line0, int s,
                                     float scale_log2, int lane) {
  const int t = lane & 3;
  // the row and chunk this lane addresses for an A tile (q) and for p.v's
  // transposed B and the output (v, o): rows 0-15, chunks c and c+1
  const int a_row = lane & 15, a_chunk = lane >> 4;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_chunk = lane >> 4;
  // for q.k^T's B (k): key frames 0-15, chunks c and c+1
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_chunk = (lane >> 3) & 1;

#pragma unroll
  for (int mt = 0; mt < SP / 16; ++mt) {
    // scores of frames mt*16 .. mt*16+15 against all SP key frames
    float sc[SP / 8][4];
#pragma unroll
    for (int j = 0; j < SP / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, chunk_addr<SP, D>(qb, panel_bytes, line0, mt * 16 + a_row, 2 * kk + a_chunk));
#pragma unroll
      for (int jp = 0; jp < SP / 16; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, chunk_addr<SP, D>(kb, panel_bytes, line0, jp * 16 + k_row, 2 * kk + k_chunk));
        mma_16816(sc[2 * jp], a, b[0], b[1]);
        mma_16816(sc[2 * jp + 1], a, b[2], b[3]);
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
      a[0] = pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
      a[1] = pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
      a[2] = pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      a[3] = pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
#pragma unroll
      for (int jd = 0; jd < D / 16; ++jd) {
        uint32_t b[4];
        ldsm_x4_trans(b, chunk_addr<SP, D>(vb, panel_bytes, line0, kk * 16 + v_row,
                                           2 * jd + v_chunk));
        mma_16816(acc[2 * jd], a, b[0], b[1]);
        mma_16816(acc[2 * jd + 1], a, b[2], b[3]);
      }
    }

    // rows mt*16 .. mt*16+15 of the band into the output buffer (the TMA
    // store drops frames >= s)
#pragma unroll
    for (int jd = 0; jd < D / 16; ++jd) {
      stsm_x4(chunk_addr<SP, D>(ob, panel_bytes, line0, mt * 16 + v_row, 2 * jd + v_chunk),
              pack_bf16x2(acc[2 * jd][0] * inv[0], acc[2 * jd][1] * inv[0]),
              pack_bf16x2(acc[2 * jd][2] * inv[1], acc[2 * jd][3] * inv[1]),
              pack_bf16x2(acc[2 * jd + 1][0] * inv[0], acc[2 * jd + 1][1] * inv[0]),
              pack_bf16x2(acc[2 * jd + 1][2] * inv[1], acc[2 * jd + 1][3] * inv[1]));
    }
  }
}

// Shared memory of one block: `stages` stages of q, k and v tiles, two
// output tiles per consumer warp, 2 * stages mbarriers, 1024 bytes of
// alignment. A tile is kPanels panels of `rows` bands of SP lines.
template <int SP, int D>
__host__ __device__ constexpr long long tile_bytes(int rows) {
  return static_cast<long long>(Geom<SP, D>::kPanels) * rows * SP * Geom<SP, D>::kLineBytes;
}

template <int SP, int D>
__host__ __device__ constexpr long long smem_bytes(int rows, int stages) {
  return (3LL * stages + 2 * kConsumers) * tile_bytes<SP, D>(rows) + 16LL * stages + 1024;
}

// At most one block per SM asked of the compiler: without it ptxas caps the
// registers of SP = 16, D = 128 at 72 and spills (two blocks fit the
// register file either way).
template <int SP, int D>
__global__ void __launch_bounds__(kThreads, 1)
    short_attn_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                      int n_rows, int s, int heads, int rows_per_tile, int tiles, int stages,
                      float scale_log2) {
  using G = Geom<SP, D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t panel_bytes = static_cast<uint32_t>(rows_per_tile * SP * G::kLineBytes);
  const uint32_t tile = G::kPanels * panel_bytes;
  unsigned char* outs = smem + 3u * stages * tile;
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 2u * kConsumers * tile);
  uint64_t* empty = full + stages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 1);  // lane 0 of the stage's consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kConsumers) {
    // ---- producer: one thread issues every load ----
    if (lane == 0) {
      tma_prefetch_map(&tq);
      tma_prefetch_map(&tk);
      tma_prefetch_map(&tv);
      tma_prefetch_map(&to);
      for (int i = 0;; ++i) {
        const int t = blockIdx.x + i * gridDim.x;
        if (t >= tiles) break;
        const int st = i % stages;
        mbar_wait(&empty[st], ((i / stages) & 1) ^ 1);  // the first round passes at once
        const int n0 = (t / heads) * rows_per_tile;
        const int h0 = t % heads;
        unsigned char* dst = smem + 3u * st * tile;
        mbar_arrive_expect_tx(&full[st], 3u * tile);
#pragma unroll
        for (int p = 0; p < G::kPanels; ++p) {
          tma_load_4d(dst + p * panel_bytes, &tq, &full[st], p * G::P, h0, 0, n0);
          tma_load_4d(dst + tile + p * panel_bytes, &tk, &full[st], p * G::P, h0, 0, n0);
          tma_load_4d(dst + 2 * tile + p * panel_bytes, &tv, &full[st], p * G::P, h0, 0, n0);
        }
      }
    }
    return;
  }

  // ---- consumer warps: tile i of this block to warp i % kConsumers ----
  const uint32_t base = smem_u32(smem);
  int j = 0;  // this warp's tile count: output buffer j % 2
  for (int i = warp;; i += kConsumers, ++j) {
    const int t = blockIdx.x + i * gridDim.x;
    if (t >= tiles) break;
    const int st = i % stages;
    unsigned char* out = outs + (2u * warp + (j & 1)) * tile;
    const uint32_t ob = smem_u32(out);
    if (j >= 2 && lane == 0) bulk_wait_group_read<1>();  // tile j - 2's store has read ob
    __syncwarp();
    mbar_wait(&full[st], (i / stages) & 1);
    const int n0 = (t / heads) * rows_per_tile;
    const int h0 = t % heads;
    const uint32_t qb = base + 3u * st * tile;
    // box layout [rows][SP frames][P]: band r, frame f on line r * SP + f
    for (int r = 0; r < rows_per_tile && n0 + r < n_rows; ++r) {
      band<SP, D>(qb, qb + tile, qb + 2 * tile, ob, panel_bytes, r * SP, s, scale_log2, lane);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    fence_proxy_async_shared();  // this lane's stmatrix writes, before the TMA store reads them
    __syncwarp();
    if (lane == 0) {
#pragma unroll
      for (int p = 0; p < G::kPanels; ++p) {
        tma_store_4d(&to, out + p * panel_bytes, p * G::P, h0, 0, n0);
      }
      bulk_commit_group();
    }
  }
  if (lane == 0) bulk_wait_group<0>();
}

// The shared-memory attribute of `kernel` is raised to the card's limit once
// per device, not per launch (and never inside a graph capture, whose launches
// follow a first call); setting it twice from two threads is harmless.
template <class K>
cudaError_t allow_max_smem(K kernel, std::atomic<uint64_t>& attr_set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t{1} << dev) : 0;
  if (!bit || !(attr_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    attr_set.fetch_or(bit, std::memory_order_release);
  }
  return cudaSuccess;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  long long q_sn, q_ss, k_sn, k_ss, v_sn, v_ss;
  int n_rows, s, heads, dh;
  float scale_log2;
  cudaStream_t stream;
  int rows_per_tile, stages, grid;
};

// A map over one of q/k/v/o: dims [dh, heads, s, n_rows], the row strides
// (elements) sn and ss, boxes [P, 1, SP, rows_per_tile].
template <int SP, int D>
bool encode(CUtensorMap* map, const void* ptr, long long sn, long long ss, const Args& a) {
  using G = Geom<SP, D>;
  const uint64_t dims[4] = {static_cast<uint64_t>(D), static_cast<uint64_t>(a.heads),
                            static_cast<uint64_t>(a.s), static_cast<uint64_t>(a.n_rows)};
  const uint64_t strides[3] = {static_cast<uint64_t>(D) * 2, static_cast<uint64_t>(ss) * 2,
                               static_cast<uint64_t>(sn) * 2};
  const uint32_t box[4] = {static_cast<uint32_t>(G::P), 1u, static_cast<uint32_t>(SP),
                           static_cast<uint32_t>(a.rows_per_tile)};
  return encode_bf16_4d(map, ptr, dims, strides, box,
                        G::P == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

template <int SP, int D>
cudaError_t launch(const Args& a) {
  static std::atomic<uint64_t> attr_set{0};
  if (a.rows_per_tile < 1 || a.rows_per_tile > 256 || a.stages < kConsumers ||
      a.stages % kConsumers || a.grid < 1) {
    return cudaErrorInvalidValue;
  }
  const long long smem = smem_bytes<SP, D>(a.rows_per_tile, a.stages);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const long long tiles =
      (static_cast<long long>(a.n_rows) + a.rows_per_tile - 1) / a.rows_per_tile * a.heads;
  if (tiles > INT_MAX / 2) return cudaErrorInvalidValue;
  cudaError_t err = allow_max_smem(short_attn_kernel<SP, D>, attr_set);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, to;
  const long long o_ss = static_cast<long long>(a.heads) * D;
  if (!encode<SP, D>(&tq, a.q, a.q_sn, a.q_ss, a) || !encode<SP, D>(&tk, a.k, a.k_sn, a.k_ss, a) ||
      !encode<SP, D>(&tv, a.v, a.v_sn, a.v_ss, a) || !encode<SP, D>(&to, a.o, a.s * o_ss, o_ss, a)) {
    return cudaErrorInvalidValue;
  }
  const int grid = static_cast<int>(a.grid < tiles ? a.grid : tiles);
  short_attn_kernel<SP, D><<<grid, kThreads, static_cast<int>(smem), a.stream>>>(
      tq, tk, tv, to, a.n_rows, a.s, a.heads, a.rows_per_tile, static_cast<int>(tiles), a.stages,
      a.scale_log2);
  return cudaGetLastError();
}

template <int SP>
cudaError_t launch_dh(const Args& a) {
  switch (a.dh) {
    case 32:
      return launch<SP, 32>(a);
    case 64:
      return launch<SP, 64>(a);
    case 128:
      return launch<SP, 128>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q/k/v: bf16 device pointers to [n_rows, s, heads*dh] tensors with a unit
// last stride; element (n, i, c) of q at q + n*q_sn + i*q_ss + c (strides in
// elements, multiples of 8; pointers 16-byte aligned). o: contiguous bf16
// [n_rows, s, heads*dh], 16-byte aligned. scale_log2 = softmax scale *
// log2(e). The tile plan (ops/short_attention.py::tile_plan): tiles of
// rows_per_tile pixel rows by one head, `stages` ring stages (a multiple of
// 4), a persistent grid of at most `grid` blocks. Encodes the
// four tensor maps, launches on `stream` without synchronising and returns
// the cudaError_t of the launch (0 on success).
int tm_short_attention_bf16(const void* q, const void* k, const void* v, void* o, long long q_sn,
                            long long q_ss, long long k_sn, long long k_ss, long long v_sn,
                            long long v_ss, int n_rows, int s, int heads, int dh,
                            float scale_log2, void* stream, int rows_per_tile, int stages,
                            int grid) {
  if (n_rows < 1 || s < 1 || s > 32 || heads < 1) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, q_sn, q_ss, k_sn, k_ss, v_sn, v_ss, n_rows, s, heads, dh, scale_log2,
               static_cast<cudaStream_t>(stream), rows_per_tile, stages, grid};
  return s <= 16 ? launch_dh<16>(a) : launch_dh<32>(a);
}

// The shared-memory bytes the kernel takes for a plan, or -1 for a dh or S
// it does not take (the wrapper's plan must agree).
long long tm_short_attention_smem_bytes(int s, int dh, int rows_per_tile, int stages) {
  const bool short_s = s <= 16;
  switch (dh) {
    case 32:
      return short_s ? smem_bytes<16, 32>(rows_per_tile, stages)
                     : smem_bytes<32, 32>(rows_per_tile, stages);
    case 64:
      return short_s ? smem_bytes<16, 64>(rows_per_tile, stages)
                     : smem_bytes<32, 64>(rows_per_tile, stages);
    case 128:
      return short_s ? smem_bytes<16, 128>(rows_per_tile, stages)
                     : smem_bytes<32, 128>(rows_per_tile, stages);
    default:
      return -1;
  }
}

const char* tm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
