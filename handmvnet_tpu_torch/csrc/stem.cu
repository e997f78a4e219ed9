// ResNet stem: the exact 7x7 / stride-2 / pad-3 convolution, 3 -> 64 channels.
//
// Replaces: handmvnet_tpu/ops/pallas/stem.py, _stem_kernel launched by
// stem_s2d_fused (a 2x2 space-to-depth im2col in VMEM and one [rows, 192] x
// [192, 64] matrix product per row tile, f32 accumulation).
//
// Shapes on the main path (b1 x v8): x [8, 3, 256, 256] -> y [8, 64, 128, 128],
// 2.47 GFLOP. In bf16 it moves 20 MB, 16.8 MB of it the NCHW output: 6.0 us at
// 3.35 TB/s, against 2.5 us of tensor-core work at 989 TFLOP/s, so the bf16
// path is bound by bytes, above all by the output write. In fp32 it moves
// 40 MB (11.9 us) against 15.0 us of 3xTF32 tensor-core work (three TF32
// products per f32 product at 495 TFLOP/s, mma.cuh), so it is bound by
// operations; on the CUDA cores alone (67 TFLOP/s) the same work is 37 us.
//
// bf16 (stem_conv_bf16_mma): an implicit GEMM on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulation, output rounded once, as the Pallas
// kernel's dot_general with preferred_element_type f32). C [64 channels,
// pixels] = W [64, K] x im2col [K, pixels], K = the 147 taps in OIHW order
// (c, kh, kw) padded with zero weights to 160: the weights need no reordering,
// and 160 wastes 8% of the products where the TPU kernel's space-to-depth
// order (192) would waste 23%.
// A block owns an 8 x 32 output tile of one image (512 blocks on the main
// path) and all 64 channels; each of its 8 warps takes one output row. It
// stages the weights ([64][160] in bf16, 336-byte rows so ldmatrix is free of
// bank conflicts; A fragments by ldmatrix), the zero-filled 21 x 69 x 3 input
// patch (the conv's padding and any ragged edge: no size has to be even or a
// tile multiple) and a table of each tap's patch offset; B fragments are
// gathered from the patch (im2col on the fly). The output, 80% of the bytes,
// leaves through shared memory: C fragments, channel rows x pixel columns, are
// rounded to bf16 and staged there (over the operands), and each channel's
// run of 32 output columns is written in coalesced 16-byte stores (element
// stores where the width is not a multiple of 8). 33.8 KB of static shared
// memory.
// Measured (kernel_variants.py): of the tiles 8 x 32, 4 x 64 and 2 x 128 the
// first is the fastest (it stages the smallest patch). The kernel stays ~4x
// its bound, and the stores are not what holds it: without them it is barely
// faster, without its gathers and products much faster. The serial phases of
// each block (stage, sync, gather + mma, sync, store) overlap only across the
// two blocks an SM holds; a persistent block with the next tile's patch in
// flight is the next step.
//
// fp32 (stem_conv_tf32x3_mma): the same implicit GEMM on the tensor cores in
// 3xTF32 (mma.sync m16n8k8, each f32 operand split into TF32 hi and lo parts,
// lo*hi + hi*lo + hi*hi in one f32 accumulator; mma.cuh), which holds f32's
// 1e-5 x max tolerance where one TF32 product (11 bits) would not. K is the
// 147 taps padded to 152 (19 k-steps of 8, 3% wasted), the padded taps with
// zero weights and zero inputs. Each block reads the weights straight into A
// fragments (a thread gathers a lane's four values), splits them once and
// stores the hi and lo planes in shared memory as 16-byte fragment words, so
// the product loop converts nothing for A and loads each A fragment in one
// instruction (staging them by element instead, with 4-way bank conflicts,
// was 9% slower). The patch is staged in f32, zero-filled outside the image;
// B fragments are gathered from it and split in registers, the two taps of a
// fragment from one 8-byte load of the offset table (k permuted within each
// step, mma.cuh). The output leaves as in bf16, staged over the weight planes
// (264-word rows: conflict-free 8-byte fragment stores) and written in 16-byte
// stores. 95.8 KB of dynamic shared memory (weights 76 KB, patch 17 KB): two
// blocks an SM. Per warp and k-step: 8 gathers and 8 splits, 8 16-byte
// fragment loads, 48 products.
// Measured (kernel_variants.py): 8 x 32 tiles beat 4 x 64 by a fifth. The
// gathers and products take ~60% of the time, their 7.6 GFLOP of TF32
// products running at ~280 TFLOP/s (57% of the TF32 peak); the staging and
// the output, which overlap them only across the two blocks an SM holds,
// take most of the rest. wgmma, or a persistent block that overlaps them,
// is the next step.
//
// Input strides are free (the model passes an NHWC image as an NCHW view);
// weights are contiguous OIHW and the output is contiguous NCHW.

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kCin = 3;
constexpr int kK = 7;
constexpr int kCout = 64;
constexpr int kTaps = kCin * kK * kK;       // 147

// ---- fp32: tensor cores in 3xTF32 -----------------------------------------

constexpr int kFTH = 8;                          // output rows per block
constexpr int kFTW = 32;                         // output columns per block
constexpr int kFPx = kFTH * kFTW;                // 256 pixels
constexpr int kFWarps = kFPx / 32;               // 8: 32 pixels of one output row each
constexpr int kFThreads = kFWarps * 32;
constexpr int kFK = 152;                         // 147 taps padded to 19 k-steps of 8
constexpr int kFSteps = kFK / 8;
constexpr int kFMTiles = kCout / 16;             // 4
constexpr int kFWords = kFK * kCout;             // words of one weight plane (fragments)
constexpr int kFPRows = 2 * kFTH + kK - 2;       // 21
constexpr int kFPRow = (2 * kFTW + kK - 2) * kCin;  // 69 columns x 3 channels
constexpr int kFPatch = kFPRows * kFPRow;        // 4347 staged inputs
constexpr int kFORow = kFPx + 8;                 // 264-word output rows
constexpr int kFOperandBytes = (2 * kFWords + kFK + kFPatch) * 4;
constexpr int kFOutBytes = kCout * kFORow * 4;
constexpr int kFSmemBytes = kFOperandBytes > kFOutBytes ? kFOperandBytes : kFOutBytes;
static_assert(kFTW % 32 == 0 && kFOutBytes <= 2 * kFWords * 4, "tile shape; output over weights");

__global__ void __launch_bounds__(kFThreads, 2)
stem_conv_tf32x3_mma(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ y, int height, int width, int hout, int wout,
                     long long sn, long long sc, long long sh, long long sw, bool vec_store) {
  extern __shared__ uint4 smem_f[];
  uint32_t* wh_s = reinterpret_cast<uint32_t*>(smem_f);  // weights' hi parts, A fragments
  uint32_t* wl_s = wh_s + kFWords;                       // their lo parts
  int* tab_s = reinterpret_cast<int*>(wl_s + kFWords);   // [kFK]
  float* p_s = reinterpret_cast<float*>(tab_s + kFK);    // [row][col][c]

  const int n = blockIdx.z;
  const int oh0 = blockIdx.y * kFTH, ow0 = blockIdx.x * kFTW;
  const int ih0 = 2 * oh0 - 3, iw0 = 2 * ow0 - 3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  {  // every load of the weights and the patch in flight at once, then the stores
    // the weights go straight into A fragments: fragment f (k-step f / 128,
    // m tile f / 32 % 4, lane f % 32) is rows g, g+8 of taps 2t, 2t+1 (k
    // permuted, mma.cuh), zero past tap 147, split once here into hi and lo
    // and stored as one 16-byte word a plane: the product loop converts
    // nothing for A
    constexpr int kFrags = kFSteps * kFMTiles * 32;
    constexpr int kWIters = (kFrags + kFThreads - 1) / kFThreads;
    constexpr int kPIters = (kFPatch + kFThreads - 1) / kFThreads;
    const float* xn = x + n * sn;
    float rw[kWIters][4], rp[kPIters];
#pragma unroll
    for (int it = 0; it < kWIters; ++it) {
      const int f = tid + it * kFThreads;
      const int oc = (f >> 5 & (kFMTiles - 1)) * 16 + (f & 31) / 4;
      const int k = (f >> 7) * 8 + 2 * (f & 3);
#pragma unroll
      for (int reg = 0; reg < 4; ++reg) {  // a0..a3: (g, 2t), (g+8, 2t), (g, 2t+1), (g+8, 2t+1)
        const int kr = k + (reg >> 1);
        rw[it][reg] = f < kFrags && kr < kTaps ? w[(oc + 8 * (reg & 1)) * kTaps + kr] : 0.f;
      }
    }
#pragma unroll
    for (int it = 0; it < kPIters; ++it) {
      const int e = tid + it * kFThreads;
      const int c = e % kCin, col = (e / kCin) % (kFPRow / kCin), row = e / kFPRow;
      const int ih = ih0 + row, iw = iw0 + col;
      const bool in = e < kFPatch && ih >= 0 && ih < height && iw >= 0 && iw < width;
      rp[it] = in ? xn[c * sc + ih * sh + iw * sw] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kWIters; ++it) {
      const int f = tid + it * kFThreads;
      if (f < kFrags) {
        uint4 hi, lo;
        split_tf32(rw[it][0], hi.x, lo.x);
        split_tf32(rw[it][1], hi.y, lo.y);
        split_tf32(rw[it][2], hi.z, lo.z);
        split_tf32(rw[it][3], hi.w, lo.w);
        reinterpret_cast<uint4*>(wh_s)[f] = hi;
        reinterpret_cast<uint4*>(wl_s)[f] = lo;
      }
    }
#pragma unroll
    for (int it = 0; it < kPIters; ++it) {
      const int e = tid + it * kFThreads;
      if (e < kFPatch) p_s[e] = rp[it];
    }
    if (tid < kFK) {  // tap (c, kh, kw) -> patch offset; padded taps read offset 0
      const int c = tid / (kK * kK), kh = (tid / kK) % kK, kw = tid % kK;
      tab_s[tid] = tid < kTaps ? kh * kFPRow + kw * kCin + c : 0;
    }
  }
  __syncthreads();

  // this lane's pixel of n8 tile j: output row warp / (kFTW / 32), column
  // (warp % (kFTW / 32)) * 32 + 8j + g of the tile, 16 input columns apart
  const int oy = warp / (kFTW / 32), ox0 = (warp % (kFTW / 32)) * 32;
  const float* pix = p_s + 2 * oy * kFPRow + 2 * (ox0 + g) * kCin;
  const uint4* ah_s = reinterpret_cast<const uint4*>(wh_s) + lane;
  const uint4* al_s = reinterpret_cast<const uint4*>(wl_s) + lane;

  float acc[kFMTiles][4][4];  // [16 channels][8 pixels][fragment]
#pragma unroll
  for (int mt = 0; mt < kFMTiles; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  // k-steps in a loop unrolled by 4, not 19: as fast, and a quarter of the code
#pragma unroll 4
  for (int ks = 0; ks < kFSteps; ++ks) {
    // taps ks*8 + 2t and + 2t+1 (k permuted): b0 and b1 of the B fragment
    const int2 off = *reinterpret_cast<const int2*>(tab_s + ks * 8 + 2 * t);
    // padded taps (only in the last step) carry zero weights; zero their
    // inputs too, so an inf or NaN in the image cannot leak in through them
    const int k0 = ks * 8 + 2 * t;
    const bool last = ks == kFSteps - 1;
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_tf32(!last || k0 < kTaps ? pix[j * 16 * kCin + off.x] : 0.f, bh[j][0], bl[j][0]);
      split_tf32(!last || k0 + 1 < kTaps ? pix[j * 16 * kCin + off.y] : 0.f, bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int mt = 0; mt < kFMTiles; ++mt) {
      const uint4 h = ah_s[(ks * kFMTiles + mt) * 32], l = al_s[(ks * kFMTiles + mt) * 32];
      const uint32_t ah[4] = {h.x, h.y, h.z, h.w}, al[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_tf32x3(acc[mt][j], ah, al, bh[j], bl[j]);
    }
  }

  // epilogue: stage as [channel][pixel] over the weights, then write each
  // channel's output rows in 16-byte pieces
  __syncthreads();
  float* o_s = reinterpret_cast<float*>(smem_f);
  const int px0 = oy * kFTW + ox0;
#pragma unroll
  for (int mt = 0; mt < kFMTiles; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int px = px0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(o_s + (mt * 16 + g) * kFORow + px) =
          make_float2(acc[mt][j][0], acc[mt][j][1]);
      *reinterpret_cast<float2*>(o_s + (mt * 16 + g + 8) * kFORow + px) =
          make_float2(acc[mt][j][2], acc[mt][j][3]);
    }
  }
  __syncthreads();
  const long long plane = static_cast<long long>(hout) * wout;
  float* yn = y + n * kCout * plane;
  constexpr int kChunks = kCout * kFTH * (kFTW / 4);
#pragma unroll
  for (int it = 0; it < kChunks / kFThreads; ++it) {
    const int i = tid + it * kFThreads;
    const int oc = i / (kFTH * (kFTW / 4)), r = (i / (kFTW / 4)) % kFTH, c4 = (i % (kFTW / 4)) * 4;
    const int oh = oh0 + r, ow = ow0 + c4;
    if (oh >= hout || ow >= wout) continue;
    const float* src = o_s + oc * kFORow + r * kFTW + c4;
    float* dst = yn + oc * plane + static_cast<long long>(oh) * wout + ow;
    if (vec_store) {  // wout % 4 == 0: the 4 columns are all inside
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    } else {
      for (int e = 0; e < 4 && ow + e < wout; ++e) dst[e] = src[e];
    }
  }
}

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int kGTH = 8;                          // output rows per block
constexpr int kGTW = 32;                         // output columns per block
constexpr int kGPx = kGTH * kGTW;                // 256 pixels
constexpr int kGWarps = kGPx / 32;               // 8: one output row each
constexpr int kGThreads = kGWarps * 32;
constexpr int kGK = 160;                         // 147 taps padded to 10 k-steps
constexpr int kGWRow = kGK + 8;                  // 336-byte weight rows
constexpr int kGPRows = 2 * kGTH + kK - 2;       // 21
constexpr int kGPRow = (2 * kGTW + kK - 2) * kCin;  // 69 columns x 3 channels
constexpr int kGPatch = kGPRows * kGPRow;        // 4347 staged inputs
constexpr int kGORow = kGPx + 8;                 // 528-byte output rows
constexpr int kGWBytes = kCout * kGWRow * 2;
constexpr int kGTabBytes = kGK * 4;
constexpr int kGOperandBytes = kGWBytes + kGTabBytes + kGPatch * 2;
constexpr int kGOutBytes = kCout * kGORow * 2;
constexpr int kGSmemBytes = kGOperandBytes > kGOutBytes ? kGOperandBytes : kGOutBytes;
static_assert(kGTW % 32 == 0 && kGSmemBytes <= 48 * 1024, "tile shape; static shared memory");

__global__ void __launch_bounds__(kGThreads, 2)
stem_conv_bf16_mma(const unsigned short* __restrict__ x, const unsigned short* __restrict__ w,
                   __nv_bfloat16* __restrict__ y, int height, int width, int hout, int wout,
                   long long sn, long long sc, long long sh, long long sw, bool vec_store) {
  __shared__ __align__(16) unsigned char smem[kGSmemBytes];
  unsigned short* w_s = reinterpret_cast<unsigned short*>(smem);        // [oc][kGWRow]
  int* tab_s = reinterpret_cast<int*>(smem + kGWBytes);                 // [kGK]
  unsigned short* p_s = reinterpret_cast<unsigned short*>(smem + kGWBytes + kGTabBytes);
  // [row][col][c]

  const int n = blockIdx.z;
  const int oh0 = blockIdx.y * kGTH, ow0 = blockIdx.x * kGTW;
  const int ih0 = 2 * oh0 - 3, iw0 = 2 * ow0 - 3;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  {  // every load of the weights and the patch in flight at once, then the stores
    constexpr int kWIters = (kCout * kTaps + kGThreads - 1) / kGThreads;
    constexpr int kPIters = (kGPatch + kGThreads - 1) / kGThreads;
    const unsigned short* xn = x + n * sn;
    unsigned short rw[kWIters], rp[kPIters];
#pragma unroll
    for (int it = 0; it < kWIters; ++it) {
      const int e = tid + it * kGThreads;
      rw[it] = e < kCout * kTaps ? w[e] : 0;
    }
#pragma unroll
    for (int it = 0; it < kPIters; ++it) {
      const int e = tid + it * kGThreads;
      const int c = e % kCin, col = (e / kCin) % (kGPRow / kCin), row = e / kGPRow;
      const int ih = ih0 + row, iw = iw0 + col;
      const bool in = e < kGPatch && ih >= 0 && ih < height && iw >= 0 && iw < width;
      rp[it] = in ? xn[c * sc + ih * sh + iw * sw] : 0;
    }
#pragma unroll
    for (int it = 0; it < kWIters; ++it) {
      const int e = tid + it * kGThreads;
      if (e < kCout * kTaps) w_s[(e / kTaps) * kGWRow + e % kTaps] = rw[it];
    }
    for (int e = tid; e < kCout * (kGWRow - kTaps); e += kGThreads)  // zero weights of taps 147..
      w_s[(e / (kGWRow - kTaps)) * kGWRow + kTaps + e % (kGWRow - kTaps)] = 0;
#pragma unroll
    for (int it = 0; it < kPIters; ++it) {
      const int e = tid + it * kGThreads;
      if (e < kGPatch) p_s[e] = rp[it];
    }
    if (tid < kGK) {  // tap (c, kh, kw) -> patch offset; padded taps read offset 0
      const int c = tid / (kK * kK), kh = (tid / kK) % kK, kw = tid % kK;
      tab_s[tid] = tid < kTaps ? kh * kGPRow + kw * kCin + c : 0;
    }
  }
  __syncthreads();

  // this lane's pixel of each n8 tile: output row warp / (kGTW / 32),
  // columns (warp % (kGTW / 32)) * 32 + 8j + g of the tile
  const int oy = warp / (kGTW / 32), ox0 = (warp % (kGTW / 32)) * 32;
  const unsigned short* pix[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) pix[j] = p_s + 2 * oy * kGPRow + 2 * (ox0 + 8 * j + g) * kCin;

  float acc[kCout / 16][4][4];  // [16 channels][8 pixels][fragment]
#pragma unroll
  for (int mt = 0; mt < kCout / 16; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

#pragma unroll
  for (int ks = 0; ks < kGK / 16; ++ks) {
    // taps ks*16 + 2t + {0, 1} and + {8, 9}: b0 and b1 of the B fragment
    const int2 o01 = *reinterpret_cast<const int2*>(tab_s + ks * 16 + 2 * t);
    const int2 o89 = *reinterpret_cast<const int2*>(tab_s + ks * 16 + 8 + 2 * t);
    // padded taps (only in the last step) carry zero weights; zero their
    // inputs too, so an inf or NaN in the image cannot leak in through them
    const int k0 = ks * 16 + 2 * t;
    const bool last = ks == kGK / 16 - 1;
    uint32_t bf[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned short e0 = !last || k0 < kTaps ? pix[j][o01.x] : 0;
      const unsigned short e1 = !last || k0 + 1 < kTaps ? pix[j][o01.y] : 0;
      const unsigned short e8 = !last || k0 + 8 < kTaps ? pix[j][o89.x] : 0;
      const unsigned short e9 = !last || k0 + 9 < kTaps ? pix[j][o89.y] : 0;
      bf[j][0] = pack_raw(e0, e1);
      bf[j][1] = pack_raw(e8, e9);
    }
#pragma unroll
    for (int mt = 0; mt < kCout / 16; ++mt) {
      uint32_t a[4];
      ldmatrix_x4(a, w_s + (mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kGWRow + ks * 16 +
                         (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a, bf[j][0], bf[j][1]);
    }
  }

  // epilogue: round, stage as [channel][pixel] over the operands, then write
  // each channel's output rows in 16-byte pieces
  __syncthreads();
  unsigned short* o_s = reinterpret_cast<unsigned short*>(smem);
  const int px0 = oy * kGTW + ox0;
#pragma unroll
  for (int mt = 0; mt < kCout / 16; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int px = px0 + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(o_s + (mt * 16 + g) * kGORow + px) =
          pack_bf16(acc[mt][j][0], acc[mt][j][1]);
      *reinterpret_cast<uint32_t*>(o_s + (mt * 16 + g + 8) * kGORow + px) =
          pack_bf16(acc[mt][j][2], acc[mt][j][3]);
    }
  }
  __syncthreads();
  const long long plane = static_cast<long long>(hout) * wout;
  unsigned short* yn = reinterpret_cast<unsigned short*>(y) + n * kCout * plane;
  constexpr int kChunks = kCout * kGTH * (kGTW / 8);
#pragma unroll
  for (int it = 0; it < kChunks / kGThreads; ++it) {
    const int i = tid + it * kGThreads;
    const int oc = i / (kGTH * (kGTW / 8)), r = (i / (kGTW / 8)) % kGTH, c8 = (i % (kGTW / 8)) * 8;
    const int oh = oh0 + r, ow = ow0 + c8;
    if (oh >= hout || ow >= wout) continue;
    const unsigned short* src = o_s + oc * kGORow + r * kGTW + c8;
    unsigned short* dst = yn + oc * plane + static_cast<long long>(oh) * wout + ow;
    if (vec_store) {  // wout % 8 == 0: the 8 columns are all inside
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && ow + e < wout; ++e) dst[e] = src[e];
    }
  }
}

}  // namespace

extern "C" {

// x: [n, 3, height, width] with element strides (sn, sc, sh, sw); w: contiguous
// [64, 3, 7, 7]; y: contiguous [n, 64, (height+1)/2, (width+1)/2].
// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaGetLastError().
int hmv_stem_conv(const void* x, const void* w, void* y, int dtype, int n,
                  int height, int width, long long sn, long long sc,
                  long long sh, long long sw, void* stream) {
  if (n < 1 || n > 65535 || height < 1 || width < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hout = (height - 1) / 2 + 1, wout = (width - 1) / 2 + 1;
  if (dtype == 0) {
    // above 48 KB of shared memory only after this opt-in (idempotent, cheap)
    const cudaError_t err = cudaFuncSetAttribute(
        stem_conv_tf32x3_mma, cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool vec_store = wout % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
    const dim3 grid((wout + kFTW - 1) / kFTW, (hout + kFTH - 1) / kFTH, n);
    stem_conv_tf32x3_mma<<<grid, kFThreads, kFSmemBytes, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y),
        height, width, hout, wout, sn, sc, sh, sw, vec_store);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const bool vec_store = wout % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid((wout + kGTW - 1) / kGTW, (hout + kGTH - 1) / kGTH, n);
  stem_conv_bf16_mma<<<grid, kGThreads, 0, s>>>(
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(w),
      static_cast<__nv_bfloat16*>(y), height, width, hout, wout, sn, sc, sh, sw, vec_store);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
