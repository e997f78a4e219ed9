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
// of a few round trips to memory, which is what the design minimises.
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
// fp32 (attention_fwd_kernel<float>): a CUDA-core kernel with f32 FMAs. It
// already beats the library call, and the tensor cores' TF32 would not hold
// the 2e-5 tolerance. Its design: the query rows are split over blocks, grid
// (B*H, ceil(Nq/8)), and each block streams the keys in tiles of 32 with an
// online (running max, running sum) softmax, the ragged last tile masked to
// -inf. The next key tile is loaded into registers while the
// current one is computed, so a block waits on memory once, not once per tile;
// K is stored transposed and Q and P are read four-wide, so the inner loops
// need few shared loads per FMA. 38.4 KB of static shared memory.
//
// Strided inputs: q/k/v/o are addressed as base + b*sb + h*sh + n*sn + d, so the
// caller passes the projections' [b, n, h, d] views without a copy.

#include <math.h>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kD = 128;   // head width (dim_head of every fusion block)
constexpr int kTQ = 8;    // query rows per block
constexpr int kTK = 32;   // keys per tile (one per lane)
constexpr int kThreads = 128;  // = kD: thread t owns output column t
constexpr int kRowsPerWarp = kTQ / (kThreads / 32);  // 2
static_assert(kThreads == kD, "one thread per head-dim column");
static_assert(kRowsPerWarp * (kThreads / 32) == kTQ && kTK == 32, "tile shape");

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows k0 .. k0+31 of one column of K and V; rows past nk read as 0
template <typename R>
__device__ __forceinline__ void load_tile(const R* __restrict__ kb, const R* __restrict__ vb,
                                          long long ksn, long long vsn, int k0, int nk,
                                          R (&rk)[kTK], R (&rv)[kTK]) {
#pragma unroll
  for (int j = 0; j < kTK; ++j) {
    const bool in = k0 + j < nk;
    rk[j] = in ? kb[(k0 + j) * ksn] : R(0);
    rv[j] = in ? vb[(k0 + j) * vsn] : R(0);
  }
}

struct Strides {
  long long b, h, n;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int heads,
                     int nq, int nk, Strides qs, Strides ks, Strides vs,
                     Strides os, float scale) {
  __shared__ __align__(16) float q_s[kTQ][kD];
  __shared__ float kt_s[kD][kTK + 1];  // K transposed; +1 keeps both the
                                       // column stores and row reads conflict-free
  __shared__ float v_s[kTK][kD];
  __shared__ __align__(16) float p_s[kTQ][kTK];
  __shared__ float alpha_s[kTQ];
  __shared__ float l_s[kTQ];

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int q0 = blockIdx.y * kTQ;
  const int tid = threadIdx.x;  // also the head-dim column this thread loads
  const int lane = tid & 31;
  const int warp = tid >> 5;

  using R = typename Raw<T>::type;
  const R* qb = reinterpret_cast<const R*>(q) + b * qs.b + h * qs.h + tid;
  const R* kb = reinterpret_cast<const R*>(k) + b * ks.b + h * ks.h + tid;
  const R* vb = reinterpret_cast<const R*>(v) + b * vs.b + h * vs.h + tid;
  T* ob = o + b * os.b + h * os.h + tid;

  {
    R r[kTQ];
#pragma unroll
    for (int i = 0; i < kTQ; ++i) r[i] = q0 + i < nq ? qb[(q0 + i) * qs.n] : R(0);
#pragma unroll
    for (int i = 0; i < kTQ; ++i) q_s[i][tid] = Raw<T>::f32(r[i]);
  }

  // column tid of the next key tile, loaded into registers while the
  // current tile is computed
  R rk[kTK], rv[kTK];
  load_tile(kb, vb, ks.n, vs.n, 0, nk, rk, rv);

  // running max and sum of the rows this warp owns (warp * 2 + r), the same
  // value in every lane; acc holds output column tid of all 8 rows
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  float acc[kTQ];
#pragma unroll
  for (int i = 0; i < kTQ; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < nk; k0 += kTK) {
    __syncthreads();  // the previous tile's readers of kt_s/v_s/p_s are done
#pragma unroll
    for (int j = 0; j < kTK; ++j) {
      kt_s[tid][j] = Raw<T>::f32(rk[j]);
      v_s[j][tid] = Raw<T>::f32(rv[j]);
    }
    __syncthreads();
    if (k0 + kTK < nk) load_tile(kb, vb, ks.n, vs.n, k0 + kTK, nk, rk, rv);

    // logits of rows i0, i0+1 against key k0 + lane
    const int i0 = warp * kRowsPerWarp;
    float s[kRowsPerWarp] = {0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < kD; d += 4) {
      const float k_d0 = kt_s[d][lane], k_d1 = kt_s[d + 1][lane];
      const float k_d2 = kt_s[d + 2][lane], k_d3 = kt_s[d + 3][lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(&q_s[i0 + r][d]);
        s[r] = fmaf(qv.x, k_d0, fmaf(qv.y, k_d1, fmaf(qv.z, k_d2, fmaf(qv.w, k_d3, s[r]))));
      }
    }
    const bool key_valid = k0 + lane < nk;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = key_valid ? s[r] * scale : -INFINITY;
      // every tile holds at least one valid key, so m_new is finite
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = expf(sr - m_new);
      const float alpha = expf(m[r] - m_new);  // 0 on the first tile
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      p_s[i0 + r][lane] = p;
      if (lane == 0) alpha_s[i0 + r] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kTQ; ++i) acc[i] *= alpha_s[i];
#pragma unroll 2
    for (int j = 0; j < kTK; j += 4) {
      const float v0 = v_s[j][tid], v1 = v_s[j + 1][tid];
      const float v2 = v_s[j + 2][tid], v3 = v_s[j + 3][tid];
#pragma unroll
      for (int i = 0; i < kTQ; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(&p_s[i][j]);
        acc[i] = fmaf(p.w, v3, fmaf(p.z, v2, fmaf(p.y, v1, fmaf(p.x, v0, acc[i]))));
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) l_s[warp * kRowsPerWarp + r] = l[r];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    const int row = q0 + i;
    if (row < nq) store(ob + row * os.n, acc[i] / l_s[i]);
  }
}

// ---- bf16: tensor cores ---------------------------------------------------

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

// cp.async and the 16-byte stores need every row of q, k, v and o to start on
// 16 bytes: aligned bases, and strides in multiples of 8 elements wherever the
// dimension has more than one index
bool rows_aligned(const void* p, const Strides& s, int batch, int heads, int n) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (batch == 1 || s.b % 8 == 0) &&
         (heads == 1 || s.h % 8 == 0) && (n == 1 || s.n % 8 == 0);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last (head
// width) dimension must be contiguous and equal to 128; in bf16 every row must
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
  if (dtype == 0) {
    const dim3 grid(batch * heads, (nq + kTQ - 1) / kTQ);
    attention_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), heads, nq, nk, qs,
        ks, vs, os, scale);
  } else if (dtype == 1) {
    if (!rows_aligned(q, qs, batch, heads, nq) || !rows_aligned(k, ks, batch, heads, nk) ||
        !rows_aligned(v, vs, batch, heads, nk) || !rows_aligned(o, os, batch, heads, nq))
      return cudaErrorInvalidValue;
    // above 48 KB of shared memory only after this opt-in (idempotent, cheap)
    const cudaError_t err = cudaFuncSetAttribute(
        attention_fwd_bf16_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(batch * heads, (nq + kMmaRows - 1) / kMmaRows);
    attention_fwd_bf16_mma<<<grid, kMmaWarps * 32, kMmaSmemBytes, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), heads,
        nq, nk, qs, ks, vs, os, scale * 1.4426950408889634f);  // log2(e): exp2 below
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
