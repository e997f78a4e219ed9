// Fused multi-head attention forward for the cross-view fusion blocks.
//
// Replaces: handmvnet_tpu/ops/pallas/attention.py, _attention_kernel launched by
// _fused_attention_pallas (one grid step per batch*head computes
// softmax(q k^T * scale) v with f32 accumulation, keys >= n_keys masked, and
// p rounded to v's dtype before the p v product).
//
// Shapes on the main path (b1 x v8): q [1, 8, Nq, 128], k/v [1, 8, Nk, 128] with
// (Nq, Nk) in {(168, 168) x2, (21, 147), (21, 21) x2}, 116 MFLOP at the largest.
// One forward's five calls move 3.6 MB in bf16: 1.1 us at 3.35 TB/s, against
// 0.5 us of tensor-core work at 989 TFLOP/s, so the bf16 path is bound by
// bytes -- and in practice by latency: so little work leaves a block the time
// of a few round trips to memory, which is what the design minimises. In fp32
// the five calls move 7.6 MB (2.3 us) against 1.5 us of 3xTF32 tensor-core
// work at 165 TFLOP/s (mma.cuh): bound by bytes, and again by latency.
//
// bf16 (attention_fwd_bf16_mma): flash-attention-2 on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulation). A block owns 16 query rows
// of one (batch, head), grid (B*H, ceil(Nq/16)); its 4 warps all hold those 16
// rows (Q as A fragments, by ldmatrix) and split the keys, each taking up to 48
// (3 blocks of 16) per pass of 192, so the 21-query shapes still run 4 warps.
// Each warp cp.async-es its own K and V slice into shared memory (rows past Nk
// zero-filled, 272-byte rows so ldmatrix is free of bank conflicts) and waits
// once: no block barrier inside the key loop. S = Q K^T takes K rows as the
// col-major B operand; the online softmax runs in registers (a row lies on the
// 4 lanes of a quad); P is rounded to bf16 in registers, as the Pallas kernel
// rounds p, and is the A operand of P V, with V through ldmatrix.trans. At the
// end the warps' (max, sum, O) merge through shared memory -- a warp with no
// keys is left out, so no exp(-inf - -inf) -- and each 128-wide output row is
// rounded once and stored in 16-byte pieces. cp.async needs 16-byte-aligned
// rows: the entry refuses other strides (cudaErrorInvalidValue).
//
// fp32 (attention_fwd_tf32x3_mma): the bf16 kernel's tiling, grid, per-warp
// cp.async slices and merge, with S = Q K^T and O = P V in 3xTF32 (mma.sync
// m16n8k8, each f32 operand split into TF32 hi and lo parts, three products;
// mma.cuh): the 2e-5 tolerance holds, where one TF32 product (11 bits) would
// not. The CUDA-core kernel it replaces ran every product as an f32 FMA and
// took three block barriers per 32-key tile; this one waits on memory once per
// pass, with no block barrier in the key loop. Q is split once while it is
// staged (each thread builds whole fragments from 8-byte loads) and kept in
// shared memory as hi and lo planes of A fragments, a 16-byte load per lane and
// k-step, rather than in registers (128 of them at D = 128). A warp walks its
// slice one 16-key block at a time in a loop that is not unrolled (S over the
// block, the online softmax, then P V); unrolled over the three blocks of a
// slice it was 6% slower (kernel_variants.py). K and V are split in registers
// as they are read (each element is read once a warp); P is split in registers
// and is not rounded, since the Pallas kernel's p.astype(v.dtype) is the
// identity in f32. k is permuted within each 8-wide step (mma.cuh): S's B
// fragment is one 8-byte load of a K row (136-word rows, conflict-free), P's C
// fragment is the next product's A fragment as it stands, and V's B fragment is
// rows 2t and 2t+1 (132-word rows, conflict-free). 48-key slices at 4 bytes
// take 217 KB of shared memory, one block an SM: the main path launches at most
// 88 blocks on 132 SMs, and every main-path shape needs a single pass (slices
// of 32 or 16 keys were no faster). The entry refuses rows not on 16 bytes, as
// in bf16.
//
// Strided inputs: q/k/v/o are addressed as base + b*sb + h*sh + n*sn + d, so the
// caller passes the projections' [b, n, h, d] views without a copy.

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kD = 128;   // head width (dim_head of every fusion block)
struct Strides {
  long long b, h, n;
};

// ---- bf16: tensor cores ---------------------------------------------------
// (its tiling, kMma* and slice_blocks, is the fp32 kernel's too)

constexpr int kMmaRows = 16;         // query rows per block: one m16 tile
constexpr int kMmaWarps = 4;         // all on the same rows, splitting the keys
constexpr int kKeyBlocks = 3;        // 16-key blocks of a warp per pass
constexpr int kSliceKeys = kKeyBlocks * 16;          // 48
constexpr int kPassKeys = kMmaWarps * kSliceKeys;    // 192
constexpr int kRowElems = kD + 8;    // 272-byte shared rows: the 8 rows of an
                                     // ldmatrix fall on 8 different bank groups
constexpr int kOStride = kD + 8;     // f32 merge rows, conflict-free float2 stores
constexpr int kMmaSmemBytes =
    (kMmaRows + kMmaWarps * 2 * kSliceKeys) * kRowElems * 2;  // Q + each warp's K, V
static_assert(kMmaWarps * kMmaRows * kOStride * 4 <= kMmaSmemBytes - kMmaRows * kRowElems * 2,
              "the merge buffer fits where K and V were");

// rows [0, 16 * blocks) of a warp's K and V slice, from key key0; keys past nk
// are zero-filled (p = 0 times stale data could be NaN)
__device__ __forceinline__ void load_slice(unsigned short* k_s, unsigned short* v_s,
                                           const __nv_bfloat16* kb, const __nv_bfloat16* vb,
                                           long long ksn, long long vsn, int key0, int blocks,
                                           int nk, int lane) {
  for (int i = lane; i < blocks * 16 * (kD / 8); i += 32) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    const bool in = key0 + r < nk;
    const long long key = in ? key0 + r : 0;
    cp_async16(k_s + r * kRowElems + c, kb + key * ksn + c, in);
    cp_async16(v_s + r * kRowElems + c, vb + key * vsn + c, in);
  }
}

// the warp's share of a pass over keys [p0, p0 + kPassKeys): 16-key blocks
// [lo, lo + count) of the pass, count 0 .. kKeyBlocks
__device__ __forceinline__ int slice_blocks(int p0, int nk, int warp, int& lo) {
  const int nb = (min(kPassKeys, nk - p0) + 15) / 16;
  const int per = (nb + kMmaWarps - 1) / kMmaWarps;
  lo = min(warp * per, nb);
  return min(lo + per, nb) - lo;
}

__global__ void __launch_bounds__(kMmaWarps * 32)
attention_fwd_bf16_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       int heads, int nq, int nk, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale_log2) {
  extern __shared__ uint4 smem_mma[];
  __shared__ float m_s[kMmaWarps][kMmaRows], l_s[kMmaWarps][kMmaRows];
  unsigned short* q_s = reinterpret_cast<unsigned short*>(smem_mma);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row and column pair
  unsigned short* k_s = q_s + (kMmaRows + warp * 2 * kSliceKeys) * kRowElems;
  unsigned short* v_s = k_s + kSliceKeys * kRowElems;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kMmaRows;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

  // Q (rows past nq zero) and this warp's first slice, all in flight at once
  for (int i = tid; i < kMmaRows * (kD / 8); i += kMmaWarps * 32) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    const bool in = q0 + r < nq;
    cp_async16(q_s + r * kRowElems + c, qb + (in ? q0 + r : 0) * qs.n + c, in);
  }
  int lo;
  int blocks = slice_blocks(0, nk, warp, lo);
  load_slice(k_s, v_s, kb, vb, ks.n, vs.n, lo * 16, blocks, nk, lane);
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[kD / 16][4];  // Q as A fragments, one per 16-wide k-step over d
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    ldmatrix_x4(qf[kk], q_s + ((lane & 7) + ((lane >> 3) & 1) * 8) * kRowElems + kk * 16 +
                            (lane >> 4) * 8);

  // running max (log2 units) and sum of rows g and g+8; O over 16 n8 tiles of d
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int p0 = 0; p0 < nk; p0 += kPassKeys) {
    if (p0 > 0) {  // a later pass: only this warp reads its slice
      __syncwarp();
      blocks = slice_blocks(p0, nk, warp, lo);
      load_slice(k_s, v_s, kb, vb, ks.n, vs.n, p0 + lo * 16, blocks, nk, lane);
      cp_async_wait_all();
      __syncwarp();
    }
    if (blocks == 0) continue;  // no keys for this warp in this pass
    const int key0 = p0 + lo * 16;

    // S = Q K^T over the slice: n8 tile j holds keys key0 + 8j ..
    float s[2 * kKeyBlocks][4];
#pragma unroll
    for (int kb16 = 0; kb16 < kKeyBlocks; ++kb16) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[2 * kb16 + j / 4][j % 4] = 0.f;
      if (kb16 < blocks) {
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
          uint32_t kf[4];
          ldmatrix_x4(kf, k_s + (kb16 * 16 + (lane & 7) + (lane >> 4) * 8) * kRowElems +
                              kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * kb16], qf[kk], kf[0], kf[1]);
          mma_bf16(s[2 * kb16 + 1], qf[kk], kf[2], kf[3]);
        }
      }
    }

    // scale, mask keys >= nk (and blocks past the slice), online softmax;
    // every row has a valid key here (the slice's first), so m_new is finite
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2 * kKeyBlocks; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = j / 2 < blocks && key0 + 8 * j + 2 * t + (e & 1) < nk;
        s[j][e] = in ? s[j][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      alpha[r] = exp2f(m_r[r] - m_new);  // 0 on the warp's first pass
      m_r[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2 * kKeyBlocks; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_r[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = l_r[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: P in bf16 as the A fragment, V rows through ldmatrix.trans
#pragma unroll
    for (int kb16 = 0; kb16 < kKeyBlocks; ++kb16) {
      if (kb16 < blocks) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kb16][0], s[2 * kb16][1]),
                                pack_bf16(s[2 * kb16][2], s[2 * kb16][3]),
                                pack_bf16(s[2 * kb16 + 1][0], s[2 * kb16 + 1][1]),
                                pack_bf16(s[2 * kb16 + 1][2], s[2 * kb16 + 1][3])};
#pragma unroll
        for (int dt = 0; dt < kD / 16; ++dt) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, v_s + (kb16 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                          kRowElems + dt * 16 + (lane >> 4) * 8);
          mma_bf16(acc[2 * dt], pa, vf[0], vf[1]);
          mma_bf16(acc[2 * dt + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

  // merge the warps: O = sum_w O_w exp(m_w - m) / sum_w l_w exp(m_w - m),
  // leaving out warps that saw no key (l_w = 0, m_w = -inf)
  if (t == 0) {
    m_s[warp][g] = m_r[0], m_s[warp][g + 8] = m_r[1];
    l_s[warp][g] = l_r[0], l_s[warp][g + 8] = l_r[1];
  }
  __syncthreads();  // also: every warp is done with its K and V
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w)
      if (l_s[w][row] > 0.f) m = fmaxf(m, m_s[w][row]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w)
      if (l_s[w][row] > 0.f) l += l_s[w][row] * exp2f(m_s[w][row] - m);
    f[r] = l_r[r] > 0.f ? exp2f(m_r[r] - m) / l : 0.f;
  }
  float* o_w = reinterpret_cast<float*>(q_s + kMmaRows * kRowElems) + warp * kMmaRows * kOStride;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    *reinterpret_cast<float2*>(o_w + g * kOStride + 8 * j + 2 * t) =
        make_float2(acc[j][0] * f[0], acc[j][1] * f[0]);
    *reinterpret_cast<float2*>(o_w + (g + 8) * kOStride + 8 * j + 2 * t) =
        make_float2(acc[j][2] * f[1], acc[j][3] * f[1]);
  }
  __syncthreads();
  const float* o_all = reinterpret_cast<const float*>(q_s + kMmaRows * kRowElems);
  for (int i = tid; i < kMmaRows * (kD / 8); i += kMmaWarps * 32) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    if (q0 + r >= nq) continue;
    float sum8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float* src = o_all + (w * kMmaRows + r) * kOStride + c;
      const float4 a = *reinterpret_cast<const float4*>(src);
      const float4 bq = *reinterpret_cast<const float4*>(src + 4);
      sum8[0] += a.x, sum8[1] += a.y, sum8[2] += a.z, sum8[3] += a.w;
      sum8[4] += bq.x, sum8[5] += bq.y, sum8[6] += bq.z, sum8[7] += bq.w;
    }
    const uint4 packed = make_uint4(pack_bf16(sum8[0], sum8[1]), pack_bf16(sum8[2], sum8[3]),
                                    pack_bf16(sum8[4], sum8[5]), pack_bf16(sum8[6], sum8[7]));
    *reinterpret_cast<uint4*>(o + b * os.b + h * os.h + (q0 + r) * os.n + c) = packed;
  }
}

// ---- fp32: tensor cores in 3xTF32 -----------------------------------------
// The bf16 kernel's shape (16 query rows a block, 4 warps splitting the keys
// in 48-key slices) with every product in 3xTF32 (mma.cuh).

constexpr int kQWords = kMmaRows * kD;  // one plane of Q as A fragments
constexpr int kKRow = kD + 8;  // 136-word K rows: 8-byte B-fragment loads free of conflicts
constexpr int kVRow = kD + 4;  // 132-word V rows: 4-byte B-fragment loads free of conflicts
constexpr int kF32SmemBytes =
    (2 * kQWords + kMmaWarps * kSliceKeys * (kKRow + kVRow)) * 4;  // Q hi, lo + each warp's K, V
static_assert(kMmaWarps * kMmaRows * kOStride <= kMmaWarps * kSliceKeys * (kKRow + kVRow),
              "the merge buffer fits where K and V were");

// rows [0, 16 * blocks) of a warp's f32 K and V slice, from key key0; keys past
// nk are zero-filled (p = 0 times stale data could be NaN)
__device__ __forceinline__ void load_slice_f32(float* k_s, float* v_s, const float* kb,
                                               const float* vb, long long ksn, long long vsn,
                                               int key0, int blocks, int nk, int lane) {
  for (int i = lane; i < blocks * 16 * (kD / 4); i += 32) {
    const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
    const bool in = key0 + r < nk;
    const long long key = in ? key0 + r : 0;
    cp_async16(k_s + r * kKRow + c, kb + key * ksn + c, in);
    cp_async16(v_s + r * kVRow + c, vb + key * vsn + c, in);
  }
}

__global__ void __launch_bounds__(kMmaWarps * 32, 1)
attention_fwd_tf32x3_mma(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o, int heads, int nq,
                         int nk, Strides qs, Strides ks, Strides vs, Strides os,
                         float scale_log2) {
  extern __shared__ uint4 smem_f32[];
  __shared__ float m_s[kMmaWarps][kMmaRows], l_s[kMmaWarps][kMmaRows];
  uint32_t* qh_s = reinterpret_cast<uint32_t*>(smem_f32);  // Q's hi parts, A fragments
  uint32_t* ql_s = qh_s + kQWords;                         // their lo parts
  float* kv_all = reinterpret_cast<float*>(ql_s + kQWords);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float* k_s = kv_all + warp * kSliceKeys * (kKRow + kVRow);
  float* v_s = k_s + kSliceKeys * kKRow;

  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kMmaRows;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;

  // this warp's first slice in flight, then Q (rows past nq zero), split once
  // into hi and lo planes of A fragments: a thread builds whole fragments
  // (rows g, g+8 of d 8kk + 2t, 2t+1) from two 8-byte loads and stores each
  // plane's part as one 16-byte word
  int lo;
  int blocks = slice_blocks(0, nk, warp, lo);
  load_slice_f32(k_s, v_s, kb, vb, ks.n, vs.n, lo * 16, blocks, nk, lane);
  {
    constexpr int kIters = kQWords / 4 / (kMmaWarps * 32);
    float2 r[kIters][2];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int f = tid + it * kMmaWarps * 32;  // fragment: k-step f / 32, lane f % 32
      const int row = (f & 31) >> 2, d = (f >> 5) * 8 + 2 * (f & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qr = q0 + row + 8 * half;
        r[it][half] = qr < nq ? *reinterpret_cast<const float2*>(qb + qr * qs.n + d)
                              : make_float2(0.f, 0.f);
      }
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      uint4 hi, lo4;
      split_tf32(r[it][0].x, hi.x, lo4.x);
      split_tf32(r[it][1].x, hi.y, lo4.y);
      split_tf32(r[it][0].y, hi.z, lo4.z);
      split_tf32(r[it][1].y, hi.w, lo4.w);
      reinterpret_cast<uint4*>(qh_s)[tid + it * kMmaWarps * 32] = hi;
      reinterpret_cast<uint4*>(ql_s)[tid + it * kMmaWarps * 32] = lo4;
    }
  }
  cp_async_wait_all();
  __syncthreads();
  const uint4* qh4 = reinterpret_cast<const uint4*>(qh_s) + lane;
  const uint4* ql4 = reinterpret_cast<const uint4*>(ql_s) + lane;

  // running max (log2 units) and sum of rows g and g+8; O over 16 n8 tiles of d
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float acc[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int p0 = 0; p0 < nk; p0 += kPassKeys) {
    if (p0 > 0) {  // a later pass: only this warp reads its slice
      __syncwarp();
      blocks = slice_blocks(p0, nk, warp, lo);
      load_slice_f32(k_s, v_s, kb, vb, ks.n, vs.n, p0 + lo * 16, blocks, nk, lane);
      cp_async_wait_all();
      __syncwarp();
    }
    // the slice's 16-key blocks one at a time, in a loop not unrolled
#pragma unroll 1
    for (int kb16 = 0; kb16 < blocks; ++kb16) {
      const int key0 = p0 + (lo + kb16) * 16;

      // S = Q K^T over 16 keys: n8 tile j holds keys key0 + 8j ..; B fragment
      // (d 8kk + 2t, 2t+1; key g) is one 8-byte load, split in registers
      const float* kr = k_s + (16 * kb16 + g) * kKRow + 2 * t;
      float s[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kD / 8; ++kk) {
        const uint4 h4 = qh4[kk * 32], l4 = ql4[kk * 32];
        const uint32_t qh[4] = {h4.x, h4.y, h4.z, h4.w}, ql[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float2 kf = *reinterpret_cast<const float2*>(kr + 8 * j * kKRow + 8 * kk);
          uint32_t bh[2], bl[2];
          split_tf32(kf.x, bh[0], bl[0]);
          split_tf32(kf.y, bh[1], bl[1]);
          mma_tf32x3(s[j], qh, ql, bh, bl);
        }
      }

      // scale, mask keys >= nk, online softmax; every row has a valid key
      // here (the block's first), so m_new is finite
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = key0 + 8 * j + 2 * t + (e & 1) < nk;
          s[j][e] = in ? s[j][e] * scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        alpha[r] = exp2f(m_r[r] - m_new);  // 0 on the warp's first block
        m_r[r] = m_new;
      }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m_r[e >> 1]);
          sum[e >> 1] += s[j][e];
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l_r[r] = l_r[r] * alpha[r] + sum[r];
      }
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        acc[j][0] *= alpha[0];
        acc[j][1] *= alpha[0];
        acc[j][2] *= alpha[1];
        acc[j][3] *= alpha[1];
      }

      // O += P V over two 8-key steps: P's C fragment, as (c0, c2, c1, c3), is
      // the A fragment with column t as key 2t and t+4 as key 2t+1 (no
      // rounding: the Pallas kernel's p.astype(v.dtype) is the identity in
      // f32); V's B fragment is rows 2t and 2t+1, column g of each d tile
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const float* v0 = v_s + (16 * kb16 + 8 * j + 2 * t) * kVRow + g;
#pragma unroll
        for (int dt = 0; dt < kD / 8; ++dt) {
          uint32_t bh[2], bl[2];
          split_tf32(v0[8 * dt], bh[0], bl[0]);
          split_tf32(v0[kVRow + 8 * dt], bh[1], bl[1]);
          mma_tf32x3(acc[dt], ph, pl, bh, bl);
        }
      }
    }
  }

  // merge the warps: O = sum_w O_w exp(m_w - m) / sum_w l_w exp(m_w - m),
  // leaving out warps that saw no key (l_w = 0, m_w = -inf)
  if (t == 0) {
    m_s[warp][g] = m_r[0], m_s[warp][g + 8] = m_r[1];
    l_s[warp][g] = l_r[0], l_s[warp][g + 8] = l_r[1];
  }
  __syncthreads();  // also: every warp is done with its K and V
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w)
      if (l_s[w][row] > 0.f) m = fmaxf(m, m_s[w][row]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w)
      if (l_s[w][row] > 0.f) l += l_s[w][row] * exp2f(m_s[w][row] - m);
    f[r] = l_r[r] > 0.f ? exp2f(m_r[r] - m) / l : 0.f;
  }
  float* o_w = kv_all + warp * kMmaRows * kOStride;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    *reinterpret_cast<float2*>(o_w + g * kOStride + 8 * j + 2 * t) =
        make_float2(acc[j][0] * f[0], acc[j][1] * f[0]);
    *reinterpret_cast<float2*>(o_w + (g + 8) * kOStride + 8 * j + 2 * t) =
        make_float2(acc[j][2] * f[1], acc[j][3] * f[1]);
  }
  __syncthreads();
  for (int i = tid; i < kMmaRows * (kD / 4); i += kMmaWarps * 32) {
    const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
    if (q0 + r >= nq) continue;
    float4 sum4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float4 a = *reinterpret_cast<const float4*>(kv_all + (w * kMmaRows + r) * kOStride + c);
      sum4.x += a.x, sum4.y += a.y, sum4.z += a.z, sum4.w += a.w;
    }
    *reinterpret_cast<float4*>(o + b * os.b + h * os.h + (q0 + r) * os.n + c) = sum4;
  }
}

// cp.async and the 16-byte loads and stores need every row of q, k, v and o to
// start on 16 bytes: aligned bases, and strides in multiples of `vec` elements
// (16 bytes) wherever the dimension has more than one index
bool rows_aligned(const void* p, const Strides& s, int batch, int heads, int n, int vec) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (batch == 1 || s.b % vec == 0) &&
         (heads == 1 || s.h % vec == 0) && (n == 1 || s.n % vec == 0);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last (head
// width) dimension must be contiguous and equal to 128, and every row must
// start on 16 bytes. Returns cudaErrorInvalidValue for what the kernels do not
// take, else the launch's cudaGetLastError() code.
int hmv_attention_fwd(const void* q, const void* k, const void* v, void* o,
                      int dtype, int batch, int heads, int nq, int nk, int d,
                      long long q_sb, long long q_sh, long long q_sn,
                      long long k_sb, long long k_sh, long long k_sn,
                      long long v_sb, long long v_sh, long long v_sn,
                      long long o_sb, long long o_sh, long long o_sn,
                      float scale, void* stream) {
  if (d != kD || nq < 1 || nk < 1 || batch < 1 || heads < 1) return cudaErrorInvalidValue;
  const Strides qs{q_sb, q_sh, q_sn}, ks{k_sb, k_sh, k_sn}, vs{v_sb, v_sh, v_sn},
      os{o_sb, o_sh, o_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(batch * heads, (nq + kMmaRows - 1) / kMmaRows);
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e): exp2 in the kernels
  if (dtype == 0) {
    if (!rows_aligned(q, qs, batch, heads, nq, 4) || !rows_aligned(k, ks, batch, heads, nk, 4) ||
        !rows_aligned(v, vs, batch, heads, nk, 4) || !rows_aligned(o, os, batch, heads, nq, 4))
      return cudaErrorInvalidValue;
    // above 48 KB of shared memory only after this opt-in (idempotent, cheap)
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_tf32x3_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32SmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_fwd_tf32x3_mma<<<grid, kMmaWarps * 32, kF32SmemBytes, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), heads, nq, nk, qs, ks, vs, os, scale_log2);
  } else if (dtype == 1) {
    if (!rows_aligned(q, qs, batch, heads, nq, 8) || !rows_aligned(k, ks, batch, heads, nk, 8) ||
        !rows_aligned(v, vs, batch, heads, nk, 8) || !rows_aligned(o, os, batch, heads, nq, 8))
      return cudaErrorInvalidValue;
    // above 48 KB of shared memory only after this opt-in (idempotent, cheap)
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_bf16_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_fwd_bf16_mma<<<grid, kMmaWarps * 32, kMmaSmemBytes, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), heads,
        nq, nk, qs, ks, vs, os, scale_log2);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
