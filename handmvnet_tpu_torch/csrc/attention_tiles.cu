// Fused multi-head attention forward for the batched shapes: one block for a
// group of query tiles of one (batch, head), its K and V loaded once by TMA.
//
// Replaces: handmvnet_tpu/ops/pallas/attention.py, _attention_kernel launched by
// _fused_attention_pallas (one grid step per batch*head: softmax(q k^T * scale) v
// with f32 accumulation, keys >= n_keys masked, p normalised and then rounded to
// v's dtype before the p v product). This is the second design of that kernel;
// attention.cu holds the first, which serves the batch-1 shapes. Which of the two
// a call launches is ops/attention.py::attention_design's rule.
//
// Shapes it is built for: a training microbatch at batch 8 and an eval batch at
// batch 16 (5 views), 8 heads of 128, (Nq, Nk) in {(105, 105) x2, (21, 84),
// (21, 21) x2}: 64 or 128 (batch, head) pairs a call. At batch 16 in bf16 one
// forward's five calls move 7.0 MB (2.1 us at 3.35 TB/s) against 0.3 us of
// tensor-core work at 989 TFLOP/s: bound by bytes, and in practice by the
// latency of a block's one round trip to memory. The first design's blocks own
// 16 query rows, so each (batch, head)'s K and V crossed L2 once for every 16
// rows (7 times at Nq = 105); here they cross it once for every 64 rows. In
// fp32 the bound is bytes too (3xTF32 at 165 TFLOP/s), but mma.sync's issue
// rate and latency hold the kernel far above it (PERF.md).
//
// bf16 (attention_tiles_bf16_wgmma): a block of one warpgroup owns 64 query
// rows of one (batch, head), grid (B*H, ceil(Nq/64)); 128 rows in two
// warpgroups was slower at batch 1 to 8 and no faster at 16 (PERF.md), so
// reading a pair's K and V once for each 64 rows costs less than the fewer
// blocks do, and a 2-block cluster multicasting K and V (which would save only
// that read) was not built. One
// thread loads the block's Q rows and all of its keys' K and V by TMA
// (cp.async.bulk.tensor, 4-D tensor maps over the caller's strided [b, n, h, d]
// views, no copy), in 64-column panels with the 128-byte swizzle, Q and K on
// one mbarrier and V on another; rows past Nq or Nk arrive as zeros. The
// warpgroup then runs S = Q K^T on wgmma (m64n32k16 over 32-key chunks, both
// operands K-major in shared memory) for the whole key row at once (up to 192
// keys), so the softmax needs no running rescale: the row max and sum over the
// 4 lanes of a quad, p = exp2(s - max) / sum in f32, rounded to bf16 as the
// Pallas kernel rounds its normalised p. P stays in registers as the A operand
// of O = P V (m64n128k16, V as the transposed, MN-major B operand). O is
// rounded once, staged in the block's Q rows and stored in 16-byte pieces.
// Keys beyond 192 are the first design's (the rule sends them there; this
// entry refuses them).
//
// fp32 (attention_tiles_tf32x3_mma): mma.sync in 3xTF32 (mma.cuh), since the
// 2e-5 tolerance needs 3xTF32 and wgmma's tf32 takes K-major operands only,
// which V in its [key, d] rows is not (TMA does not transpose), and hi and lo
// planes of Q, K and a transposed V would not fit in shared memory beside each
// other. It keeps the new block shape: a block owns up to 64 query rows of one
// (batch, head), grid (B*H, ceil(Nq/64)), and loads them and all of its keys'
// K and V once by TMA, in 32-float panels with the 128-byte swizzle. Its 8
// warps are R row tiles of 16 times S = 8 / R key splits (Nq = 21: 2 x 4;
// Nq >= 64: 4 x 2), so that a small Nq still fills the block and each warp's
// share of the keys is short. K is split once for the block into TF32 hi and
// lo B fragments (one 16-byte load a fragment): each warp splitting the K it
// read was 9-13% slower at (105, 105); Q, P and V are split as they are read. lo
// = x - hi is left for the tensor core to truncate (one cvt fewer an operand;
// tests/test_torch_tf32x3.py emulates it). The swizzle makes every fragment
// load free of bank conflicts: S = Q K^T takes Q and K in the standard k order
// (t and t + 4), P V takes P's C fragment, as (c0, c2, c1, c3), as its A
// fragment (keys 2t and 2t + 1 of each 8-key step) and V rows 2t and 2t + 1. A
// warp's softmax covers its keys; the splits of a row tile merge through
// shared memory as in attention.cu (O = sum_w O_w exp(m_w - m) / sum_w l_w
// exp(m_w - m)). Keys beyond 128 go to the first design (its K and V would not
// fit beside Q).
//
// The tensor maps are encoded on the host for each call (cuTensorMapEncodeTiled,
// reached through the runtime's driver entry point) and passed as
// __grid_constant__ parameters, so a CUDA graph captures them with the launch.

#include <cuda.h>
#include <math.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kD = 128;              // head width (dim_head of every fusion block)
constexpr int kChunk = 32;           // keys of one S product
constexpr int kBf16MaxChunks = 6;    // bf16: up to 192 keys in one tile
constexpr int kF32MaxChunks = 4;     // fp32: up to 128 keys
constexpr int kBf16Rows = 64;        // bf16: query rows a block (wgmma's m64)
constexpr int kBf16Threads = 128;    // bf16: one warpgroup a block
constexpr int kPanelBytes = 128;     // one swizzled row of a panel: 64 bf16 or 32 f32
struct Strides {
  long long b, h, n;
};

// ---- wgmma ----------------------------------------------------------------

// d (+)= A B over 64 x 32 x 16: A (64 query rows) and B (32 keys) both K-major
// in shared memory; d is zeroed first unless accumulate
__device__ __forceinline__ void wgmma_n32_ss(float (&d)[16], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B over 64 x 128 x 16: A (64 rows x 16 keys) in registers, B (16 keys x
// 128 d) MN-major in shared memory
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// byte offset of element (row, col) in a matrix of `rows`-row panels of 128
// bytes with the 128-byte swizzle (16-byte chunk c of row r at c ^ (r % 8));
// `per` elements to a panel row
__device__ __forceinline__ int swz(int row, int col, int rows, int per, int elt) {
  const int byte = (col % per) * elt;
  return (col / per) * rows * kPanelBytes + row * kPanelBytes +
         ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// the block's (batch, head) and first query row; its shared memory, 1024-aligned
struct Tile {
  int b, h, q0;
};

__device__ __forceinline__ Tile block_tile(int heads, int block_rows) {
  return {static_cast<int>(blockIdx.x) / heads, static_cast<int>(blockIdx.x) % heads,
          static_cast<int>(blockIdx.y) * block_rows};
}

// one thread: Q rows [q0, q0 + rows) (the Q map's box) and all of K on bars[0],
// V on bars[1], each matrix as `panels` boxes of 128-byte rows; Q's panels
// q_rows rows apart
__device__ __forceinline__ void issue_loads(unsigned char* q_s, unsigned char* k_s,
                                            unsigned char* v_s, const CUtensorMap* qm,
                                            const CUtensorMap* km, const CUtensorMap* vm,
                                            uint64_t* bars, const Tile& tile, int rows,
                                            int q_rows, int keys, int panels, int per) {
  mbar_expect_tx(&bars[0], panels * (rows + keys) * kPanelBytes);
  for (int p = 0; p < panels; ++p) {
    tma_load(q_s + p * q_rows * kPanelBytes, qm, &bars[0], p * per, tile.q0, tile.h, tile.b);
    tma_load(k_s + p * keys * kPanelBytes, km, &bars[0], p * per, 0, tile.h, tile.b);
  }
  mbar_expect_tx(&bars[1], panels * keys * kPanelBytes);
  for (int p = 0; p < panels; ++p)
    tma_load(v_s + p * keys * kPanelBytes, vm, &bars[1], p * per, 0, tile.h, tile.b);
}

__device__ __forceinline__ void init_barriers(uint64_t* bars) {
  if (threadIdx.x == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---- bf16: wgmma ------------------------------------------------------------

constexpr int kBf16Per = kPanelBytes / 2;  // 64 bf16 columns a panel

template <int kChunks>
__global__ void __launch_bounds__(kBf16Threads, 1)
attention_tiles_bf16_wgmma(__grid_constant__ const CUtensorMap qm,
                           __grid_constant__ const CUtensorMap km,
                           __grid_constant__ const CUtensorMap vm, __nv_bfloat16* __restrict__ o,
                           int heads, int nq, int nk, Strides os, float scale_log2) {
  constexpr int kKeys = kChunks * kChunk;
  constexpr int kSteps = kKeys / 16;  // k16 steps of P V
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[2];
  unsigned char* q_s = aligned_smem(smem_raw);  // 2 panels of kBf16Rows rows
  unsigned char* k_s = q_s + 2 * kBf16Rows * kPanelBytes;  // 2 panels of kKeys rows
  unsigned char* v_s = k_s + 2 * kKeys * kPanelBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Tile tile = block_tile(heads, kBf16Rows);

  init_barriers(bars);
  if (tid == 0)
    issue_loads(q_s, k_s, v_s, &qm, &km, &vm, bars, tile, kBf16Rows, kBf16Rows, kKeys, 2,
                kBf16Per);

  // S = Q K^T over the whole key row: chunk c holds keys 32c .. 32c + 31; its
  // n8 tile j, value e: row 16 warp + g (+8 for e >= 2), key 32c + 8j + 2t + (e & 1)
  float s[kChunks][16];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) s[c][i] = 0.f;
  mbar_wait0(&bars[0]);
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_reg(s[c][i]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int panel = kk / 4, byte = (kk % 4) * 32;  // 16 bf16 = 32 bytes of a panel row
    const uint64_t a = sw128_desc(q_s + panel * kBf16Rows * kPanelBytes + byte, 16, 1024);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint64_t b = sw128_desc(
          k_s + panel * kKeys * kPanelBytes + c * kChunk * kPanelBytes + byte, 16, 1024);
      wgmma_n32_ss(s[c], a, b, kk > 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) fence_reg(s[c][i]);

  // scale, mask keys >= nk, softmax over the whole row (key 0 is valid, so the
  // max is finite), p normalised and rounded to bf16 as P's A fragments: k16
  // step ks is chunk ks / 2, n8 tiles 2 (ks % 2) and 2 (ks % 2) + 1
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = c * kChunk + 8 * (i / 4) + 2 * t + (i & 1);
      s[c][i] = key < nk ? s[c][i] * scale_log2 : -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[c][i]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      s[c][i] = exp2f(s[c][i] - mx[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += s[c][i];
    }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    inv[r] = 1.f / sum[r];
  }
  uint32_t pa[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const float* lo = &s[ks / 2][8 * (ks % 2)];  // n8 tile 2 (ks % 2)
    const float* hi = lo + 4;                    // and the next
    pa[ks][0] = pack_bf16(lo[0] * inv[0], lo[1] * inv[0]);
    pa[ks][1] = pack_bf16(lo[2] * inv[1], lo[3] * inv[1]);
    pa[ks][2] = pack_bf16(hi[0] * inv[0], hi[1] * inv[0]);
    pa[ks][3] = pack_bf16(hi[2] * inv[1], hi[3] * inv[1]);
  }

  // O = P V over every 16-key step of the tile (V's rows past nk are zeros, and
  // so are their p; skipping those steps was no faster); n8 tile j of O: d 8j +
  // 2t, 2t + 1
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  mbar_wait0(&bars[1]);
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(acc[i]);
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_reg(pa[ks][i]);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
    wgmma_n128_rs(acc, pa[ks], sw128_desc(v_s + ks * 16 * kPanelBytes,
                                          kKeys * kPanelBytes, 8 * kPanelBytes));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < 64; ++i) fence_reg(acc[i]);

  // O rounded to bf16 into the block's Q rows (the same swizzled panels), then
  // 16-byte stores of the rows < nq
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(q_s + swz(r0, col, kBf16Rows, kBf16Per, 2)) =
        pack_bf16(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(q_s + swz(r0 + 8, col, kBf16Rows, kBf16Per, 2)) =
        pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  __nv_bfloat16* ob = o + tile.b * os.b + tile.h * os.h;
  for (int f = tid; f < kBf16Rows * (kD / 8); f += kBf16Threads) {
    const int r = f / (kD / 8), col = (f % (kD / 8)) * 8, row = tile.q0 + r;
    if (row < nq)
      *reinterpret_cast<uint4*>(ob + row * os.n + col) =
          *reinterpret_cast<const uint4*>(q_s + swz(r, col, kBf16Rows, kBf16Per, 2));
  }
}

// ---- fp32: mma.sync in 3xTF32 ----------------------------------------------

constexpr int kF32Per = kPanelBytes / 4;  // 32 f32 columns a panel
constexpr int kF32Rows = 64;              // query rows a block: 4 tiles of 16
constexpr int kF32Warps = 8;              // row tiles x key splits
constexpr int kQBytes = kF32Rows * kD * 4;  // Q as TMA writes it
constexpr int kMergeBytes = 16 * kD * 4;  // one warp's partial O
constexpr int kMinSplits = kF32Warps / (kF32Rows / 16);  // key splits of a full block
static_assert(kMinSplits >= 1, "a block's warps cover its row tiles");

__device__ __forceinline__ float lds(const unsigned char* base, int off) {
  return *reinterpret_cast<const float*>(base + off);
}

// A block's kF32Warps warps: R = ceil(rows / 16) row tiles (rows = its query
// rows, at most 64) times S = min(kF32Warps / R, the 8-key tiles) key splits;
// warp w takes row tile w / S and split w % S, a contiguous run of 8-key tiles.
template <int kChunks>
__global__ void __launch_bounds__(kF32Warps * 32, 1)
attention_tiles_tf32x3_mma(__grid_constant__ const CUtensorMap qm,
                           __grid_constant__ const CUtensorMap km,
                           __grid_constant__ const CUtensorMap vm, float* __restrict__ o,
                           int heads, int nq, int nk, Strides os, float scale_log2) {
  constexpr int kKeys = kChunks * kChunk;
  constexpr int kPer = kKeys / 8 / kMinSplits;  // most 8-key tiles a warp takes
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[2];
  __shared__ float m_s[kF32Warps][16], l_s[kF32Warps][16];
  // Q (4 panels of kF32Rows rows); K as B fragments, hi and lo (TMA writes its
  // 4 panels of kKeys rows into the first half); V (4 panels of kKeys rows)
  unsigned char* q_s = aligned_smem(smem_raw);
  unsigned char* k_s = q_s + kQBytes;
  unsigned char* v_s = k_s + 2 * 4 * kKeys * kPanelBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Tile tile = block_tile(heads, kF32Rows);
  const int box = min(kF32Rows, (nq + 15) / 16 * 16);  // the Q map's box rows
  const int row_tiles = (min(kF32Rows, nq - tile.q0) + 15) / 16;
  const int tiles = (nk + 7) / 8;
  const int splits = min(kF32Warps / row_tiles, tiles);
  const int rt = warp / splits, sp = warp % splits;
  const bool active = rt < row_tiles;  // else a warp past the block's rows
  const int per = (tiles + splits - 1) / splits;
  const int lo = min(sp * per, tiles), count = active ? min(per, tiles - lo) : 0;

  init_barriers(bars);
  if (tid == 0)
    issue_loads(q_s, k_s, v_s, &qm, &km, &vm, bars, tile, box, kF32Rows, kKeys, 4, kF32Per);

  // K split once for the block into B fragments, k in the standard order:
  // fragment (tile J, kk, lane) is key 8J + g at d 8kk + t and 8kk + t + 4, one
  // 16-byte word (hi, hi, lo, lo); every thread reads its share of the raw rows
  // before any writes over them
  constexpr int kItems = kKeys / 8 * (kD / 8) * 32 / (kF32Warps * 32);
  static_assert(kItems * kF32Warps * 32 == kKeys / 8 * (kD / 8) * 32, "whole fragments a thread");
  float kv[kItems][2];
  mbar_wait0(&bars[0]);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int f = tid + i * kF32Warps * 32, fl = f & 31;
    const int key = (f >> 9) * 8 + (fl >> 2), d = ((f >> 5) & 15) * 8 + (fl & 3);
    kv[i][0] = lds(k_s, swz(key, d, kKeys, kF32Per, 4));
    kv[i][1] = lds(k_s, swz(key, d + 4, kKeys, kF32Per, 4));
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    uint4 w;
    split_hi(kv[i][0], w.x, w.z);
    split_hi(kv[i][1], w.y, w.w);
    reinterpret_cast<uint4*>(k_s)[tid + i * kF32Warps * 32] = w;
  }
  __syncthreads();

  // S = Q K^T over this warp's key tiles: tile j (keys 8 (lo + j) ..), value e:
  // row 16 rt + g (+8 for e >= 2), key 8 (lo + j) + 2t + (e & 1)
  const int r0 = 16 * (active ? rt : 0) + g;
  const uint4* kf4 = reinterpret_cast<const uint4*>(k_s) + lo * (kD / 8) * 32 + lane;
  float s[kPer][4];
#pragma unroll
  for (int j = 0; j < kPer; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < kD / 8; ++kk) {
    const int d0 = 8 * kk + t;
    uint32_t ah[4], al[4];
    split_hi(lds(q_s, swz(r0, d0, kF32Rows, kF32Per, 4)), ah[0], al[0]);
    split_hi(lds(q_s, swz(r0 + 8, d0, kF32Rows, kF32Per, 4)), ah[1], al[1]);
    split_hi(lds(q_s, swz(r0, d0 + 4, kF32Rows, kF32Per, 4)), ah[2], al[2]);
    split_hi(lds(q_s, swz(r0 + 8, d0 + 4, kF32Rows, kF32Per, 4)), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j >= count) break;
      const uint4 w = kf4[(j * (kD / 8) + kk) * 32];
      const uint32_t bh[2] = {w.x, w.y}, bl[2] = {w.z, w.w};
      mma_tf32x3(s[j], ah, al, bh, bl);
    }
  }

  // scale, mask keys >= nk (and tiles past the run), the run's max and sum; a
  // warp without keys keeps m = -inf, l = 0 and is left out of the merge
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kPer; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = j < count && 8 * (lo + j) + 2 * t + (e & 1) < nk;
      s[j][e] = in ? s[j][e] * scale_log2 : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
  if (count > 0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }

  // O = P V over the run: P's C fragment, as (c0, c2, c1, c3), is the A
  // fragment with column t as key 2t and t + 4 as key 2t + 1; V's B fragment is
  // rows 2t and 2t + 1, column g of each d tile
  float acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  mbar_wait0(&bars[1]);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j >= count) break;
    uint32_t ph[4], pl[4];
    split_hi(s[j][0], ph[0], pl[0]);
    split_hi(s[j][2], ph[1], pl[1]);
    split_hi(s[j][1], ph[2], pl[2]);
    split_hi(s[j][3], ph[3], pl[3]);
    const int key = 8 * (lo + j) + 2 * t;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      uint32_t bh[2], bl[2];
      split_hi(lds(v_s, swz(key, 8 * dt + g, kKeys, kF32Per, 4)), bh[0], bl[0]);
      split_hi(lds(v_s, swz(key + 1, 8 * dt + g, kKeys, kF32Per, 4)), bh[1], bl[1]);
      mma_tf32x3(acc[dt], ph, pl, bh, bl);
    }
  }

  // merge the splits of each row tile: O = sum_w O_w exp(m_w - m) / sum_w l_w
  // exp(m_w - m), each warp's share scaled in registers and written, swizzled,
  // over Q and K (every warp is past them at the barrier), then summed
  if (t == 0) {
    m_s[warp][g] = mx[0], m_s[warp][g + 8] = mx[1];
    l_s[warp][g] = sum[0], l_s[warp][g + 8] = sum[1];
  }
  __syncthreads();
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    float m = -INFINITY, l = 0.f;
    for (int w = rt * splits; w < (rt + 1) * splits; ++w)
      if (l_s[w][row] > 0.f) m = fmaxf(m, m_s[w][row]);
    for (int w = rt * splits; w < (rt + 1) * splits; ++w)
      if (l_s[w][row] > 0.f) l += l_s[w][row] * exp2f(m_s[w][row] - m);
    f[r] = sum[r] > 0.f ? exp2f(mx[r] - m) / l : 0.f;
  }
  unsigned char* o_w = q_s + warp * kMergeBytes;
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
    const int col = 8 * dt + 2 * t;
    *reinterpret_cast<float2*>(o_w + swz(g, col, 16, kF32Per, 4)) =
        make_float2(acc[dt][0] * f[0], acc[dt][1] * f[0]);
    *reinterpret_cast<float2*>(o_w + swz(g + 8, col, 16, kF32Per, 4)) =
        make_float2(acc[dt][2] * f[1], acc[dt][3] * f[1]);
  }
  __syncthreads();
  float* ob = o + tile.b * os.b + tile.h * os.h;
  for (int i = tid; i < row_tiles * 16 * (kD / 4); i += blockDim.x) {
    const int r = i / (kD / 4), col = (i % (kD / 4)) * 4, row = tile.q0 + r;
    if (row >= nq) continue;
    const unsigned char* src =
        q_s + (r / 16) * splits * kMergeBytes + swz(r % 16, col, 16, kF32Per, 4);
    float4 sum4 = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < splits; ++w) {
      const float4 a = *reinterpret_cast<const float4*>(src + w * kMergeBytes);
      sum4.x += a.x, sum4.y += a.y, sum4.z += a.z, sum4.w += a.w;
    }
    *reinterpret_cast<float4*>(ob + row * os.n + col) = sum4;
  }
}

// ---- host ------------------------------------------------------------------

// a 4-D map (d, n, h, b) over base + b*sb + h*sh + n*sn + d, boxes of `per`
// columns x `rows` rows with the 128-byte swizzle; rows past n read as zeros.
// A dimension of extent 1 takes a stride of 16 bytes (it is never stepped).
bool encode(CUtensorMap* map, const void* base, bool f32, int batch, int heads, int n,
            const Strides& s, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t elt = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {n == 1 ? 16 : s.n * elt, heads == 1 ? 16 : s.h * elt,
                                 batch == 1 ? 16 : s.b * elt};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kPanelBytes / elt),
                             static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA and the 16-byte stores need every row of q, k, v and o to start on 16
// bytes: aligned bases, and strides in multiples of `vec` elements (16 bytes)
// wherever the dimension has more than one index
bool rows_aligned(const void* p, const Strides& s, int batch, int heads, int n, int vec) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (batch == 1 || s.b % vec == 0) &&
         (heads == 1 || s.h % vec == 0) && (n == 1 || s.n % vec == 0);
}

struct Args {
  CUtensorMap qm, km, vm;
  void* o;
  int heads, nq, nk;
  Strides os;
  float scale_log2;
};

template <typename T, typename Kernel>
int launch(Kernel kernel, const Args& a, const dim3& grid, int threads, int smem,
           cudaStream_t st) {
  // above 48 KB of shared memory only after this opt-in (idempotent, cheap)
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, st>>>(a.qm, a.km, a.vm, static_cast<T*>(a.o), a.heads, a.nq,
                                      a.nk, a.os, a.scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// one warpgroup a block; Q's panels of kBf16Rows rows, then K's and V's of
// kChunks chunks, and the 1024-byte alignment
template <int kChunks>
int launch_bf16(const Args& a, int pairs, cudaStream_t st) {
  const dim3 grid(pairs, (a.nq + kBf16Rows - 1) / kBf16Rows);
  const int smem = kAlignSlack + 2 * (kBf16Rows + 2 * kChunks * kChunk) * kPanelBytes;
  return launch<__nv_bfloat16>(attention_tiles_bf16_wgmma<kChunks>, a, grid, kBf16Threads, smem,
                               st);
}

// kF32Warps warps a block of up to kF32Rows query rows: Q, then 4 panels each
// of K's hi and lo fragments and of V; the partial Os of the merge take their place
template <int kChunks>
int launch_f32(const Args& a, int pairs, cudaStream_t st) {
  const dim3 grid(pairs, (a.nq + kF32Rows - 1) / kF32Rows);
  const int smem = kAlignSlack + std::max(kQBytes + 12 * kChunks * kChunk * kPanelBytes,
                                          kF32Warps * kMergeBytes);
  return launch<float>(attention_tiles_tf32x3_mma<kChunks>, a, grid, kF32Warps * 32, smem, st);
}

}  // namespace

extern "C" {

// The largest key count each dtype's kernel takes in one tile (0 = float32,
// 1 = bfloat16); the rule in ops/attention.py reads it.
int hmv_attention_tiles_max_keys(int dtype) {
  return dtype == 0 ? kF32MaxChunks * kChunk : dtype == 1 ? kBf16MaxChunks * kChunk : 0;
}

// As hmv_attention_fwd (attention.cu): dtype 0 = float32, 1 = bfloat16; strides
// in elements; the head width contiguous and equal to 128; every row on 16
// bytes; nk up to hmv_attention_tiles_max_keys(dtype). Returns
// cudaErrorInvalidValue for what the kernels do not take (or a tensor map the
// driver refuses), else the launch's cudaGetLastError() code.
int hmv_attention_tiles_fwd(const void* q, const void* k, const void* v, void* o, int dtype,
                            int batch, int heads, int nq, int nk, int d, long long q_sb,
                            long long q_sh, long long q_sn, long long k_sb, long long k_sh,
                            long long k_sn, long long v_sb, long long v_sh, long long v_sn,
                            long long o_sb, long long o_sh, long long o_sn, float scale,
                            void* stream) {
  if (d != kD || nq < 1 || nk < 1 || batch < 1 || heads < 1 || (dtype != 0 && dtype != 1) ||
      nk > hmv_attention_tiles_max_keys(dtype))
    return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_sn}, ks{k_sb, k_sh, k_sn}, vs{v_sb, v_sh, v_sn},
      os{o_sb, o_sh, o_sn};
  const bool f32 = dtype == 0;
  const int vec = f32 ? 4 : 8;
  if (!rows_aligned(q, qs, batch, heads, nq, vec) || !rows_aligned(k, ks, batch, heads, nk, vec) ||
      !rows_aligned(v, vs, batch, heads, nk, vec) || !rows_aligned(o, os, batch, heads, nq, vec))
    return cudaErrorInvalidValue;
  const int chunks = (nk + kChunk - 1) / kChunk, keys = chunks * kChunk;
  // Q's box: a block's rows (bf16), or the query rows rounded up to a warp's
  // 16, at most a block's (fp32)
  const int rows = f32 ? std::min(kF32Rows, (nq + 15) / 16 * 16) : kBf16Rows;
  Args a{{}, {}, {}, o, heads, nq, nk, os, scale * 1.4426950408889634f};  // exp2 in the kernels
  if (!encode(&a.qm, q, f32, batch, heads, nq, qs, rows) ||
      !encode(&a.km, k, f32, batch, heads, nk, ks, keys) ||
      !encode(&a.vm, v, f32, batch, heads, nk, vs, keys))
    return cudaErrorInvalidValue;
  const int pairs = batch * heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32) {
    switch (chunks) {
      case 1: return launch_f32<1>(a, pairs, st);
      case 2: return launch_f32<2>(a, pairs, st);
      case 3: return launch_f32<3>(a, pairs, st);
      default: return launch_f32<4>(a, pairs, st);
    }
  }
  switch (chunks) {
    case 1: return launch_bf16<1>(a, pairs, st);
    case 2: return launch_bf16<2>(a, pairs, st);
    case 3: return launch_bf16<3>(a, pairs, st);
    case 4: return launch_bf16<4>(a, pairs, st);
    case 5: return launch_bf16<5>(a, pairs, st);
    default: return launch_bf16<6>(a, pairs, st);
  }
}

}  // extern "C"
