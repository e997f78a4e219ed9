// ResNet stem: the exact 7x7 / stride-2 / pad-3 convolution, 3 -> 64 channels.
//
// Replaces: handmvnet_tpu/ops/pallas/stem.py, _stem_kernel launched by
// stem_s2d_fused (a 2x2 space-to-depth im2col in VMEM and one [rows, 192] x
// [192, 64] matrix product per row tile, f32 accumulation).
//
// Shapes on the main path (b1 x v8): x [8, 3, 256, 256] -> y [8, 64, 128, 128],
// 2.47 GFLOP. In bf16 it moves 20 MB, 16.8 MB of it the NCHW output: 6.0 us at
// 3.35 TB/s, against 2.5 us of tensor-core work at 989 TFLOP/s, so the bf16
// path is bound by bytes, above all by the output write. In fp32 (40 MB, and
// 37 us of CUDA-core FMAs at 67 TFLOP/s) it is bound by operations.
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
// Measured (stem_variants.py): of the tiles 8 x 32, 4 x 64 and 2 x 128 the
// first is the fastest (it stages the smallest patch). The kernel stays ~4x
// its bound, and the stores are not what holds it: without them it is barely
// faster, without its gathers and products much faster. The serial phases of
// each block (stage, sync, gather + mma, sync, store) overlap only across the
// two blocks an SM holds; a persistent block with the next tile's patch in
// flight is the next step.
//
// fp32 (stem_conv_kernel<float>): a CUDA-core kernel with f32 FMAs. It
// already beats the library call, and the tensor cores' TF32 would not hold
// the 1e-5 x max tolerance. A block owns one image's 8 x 32 output tile and
// all 64 channels, one output pixel per thread with 64 f32 accumulators. It stages the [64, 3, 7, 7] weights (tap-major, so the 64
// channels of one tap are four-wide broadcast loads) and its 21 x 69 x 3 input
// patch in shared memory, zero-filled outside the image. The patch is stored
// split by column parity -- the stride-2 analogue of the TPU kernel's
// space-to-depth -- so neighbouring threads read neighbouring words. Weights
// 40 KB (rows padded) + patch 17.6 KB exceed the 48 KB static limit, so the
// kernel opts in to dynamic shared memory.
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
constexpr int kTH = 8;                      // output rows per block
constexpr int kTW = 32;                     // output columns per block (one warp)
constexpr int kThreads = kTH * kTW;         // 256
constexpr int kPatchRows = 2 * kTH + kK - 2;  // 21
constexpr int kPatchCols = 2 * kTW + kK - 2;  // 69
constexpr int kHalf = (kPatchCols + 1) / 2;   // 35 columns of each parity
constexpr int kPatch = kCin * kPatchRows * 2 * kHalf;  // 4410 staged inputs
// weight rows padded 64 -> 68: the transposing stores then hit 8 banks, not 1,
// and rows stay 16-byte aligned for the four-wide reads
constexpr int kWStride = kCout + 4;
constexpr int kSmemBytes = (kTaps * kWStride + kPatch) * 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
stem_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 T* __restrict__ y, int height, int width, int hout, int wout,
                 long long sn, long long sc, long long sh, long long sw) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);  // [tap][kWStride]
  float* p_s = w_s + kTaps * kWStride;           // [cin][row][parity][half]

  const int n = blockIdx.z;
  const int oh0 = blockIdx.y * kTH;
  const int ow0 = blockIdx.x * kTW;
  const int ih0 = 2 * oh0 - 3;
  const int iw0 = 2 * ow0 - 3;
  const int tid = threadIdx.x;

  // each staging loop has a fixed trip count, so a thread's loads are all in
  // flight at once
  using R = typename Raw<T>::type;
  {  // coalesced read of OIHW, transposed into tap-major order
    constexpr int kIters = (kTaps * kCout + kThreads - 1) / kThreads;
    const R* wr = reinterpret_cast<const R*>(w);
    R r[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int e = tid + it * kThreads;
      r[it] = e < kTaps * kCout ? wr[e] : R(0);
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int e = tid + it * kThreads;
      if (e < kTaps * kCout) w_s[(e % kTaps) * kWStride + e / kTaps] = Raw<T>::f32(r[it]);
    }
  }
  {  // the input patch, zero outside the image
    constexpr int kIters = (kPatch + kThreads - 1) / kThreads;
    const R* xn = reinterpret_cast<const R*>(x) + n * sn;
    R r[kIters];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int e = tid + it * kThreads;
      const int col = e % (2 * kHalf);
      const int row = (e / (2 * kHalf)) % kPatchRows;
      const int c = e / (2 * kHalf * kPatchRows);
      const int ih = ih0 + row, iw = iw0 + col;
      const bool in = e < kPatch && ih >= 0 && ih < height && iw >= 0 && iw < width;
      r[it] = in ? xn[c * sc + ih * sh + iw * sw] : R(0);
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
      const int e = tid + it * kThreads;
      const int col = e % (2 * kHalf);
      const int rc = e / (2 * kHalf);  // c * kPatchRows + row
      if (e < kPatch) p_s[(rc * 2 + (col & 1)) * kHalf + (col >> 1)] = Raw<T>::f32(r[it]);
    }
  }
  __syncthreads();

  const int tx = tid % kTW;  // output column in the tile
  const int ty = tid / kTW;  // output row in the tile
  float acc[kCout];
#pragma unroll
  for (int oc = 0; oc < kCout; ++oc) acc[oc] = 0.f;

#pragma unroll 1
  for (int c = 0; c < kCin; ++c) {
#pragma unroll 1
    for (int kh = 0; kh < kK; ++kh) {
      // input column 2*tx + kw has parity kw & 1 and half-index tx + kw / 2
      const float* prow = p_s + ((c * kPatchRows + 2 * ty + kh) * 2) * kHalf + tx;
      const float4* wtap = reinterpret_cast<const float4*>(w_s + (c * kK + kh) * kK * kWStride);
#pragma unroll
      for (int kw = 0; kw < kK; ++kw) {
        const float xv = prow[(kw & 1) * kHalf + (kw >> 1)];
#pragma unroll
        for (int q = 0; q < kCout / 4; ++q) {
          const float4 w4 = wtap[kw * (kWStride / 4) + q];
          acc[4 * q + 0] = fmaf(xv, w4.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(xv, w4.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv, w4.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv, w4.w, acc[4 * q + 3]);
        }
      }
    }
  }

  const int oh = oh0 + ty, ow = ow0 + tx;
  if (oh < hout && ow < wout) {
    const long long plane = static_cast<long long>(hout) * wout;
    T* yp = y + static_cast<long long>(n) * kCout * plane + static_cast<long long>(oh) * wout + ow;
#pragma unroll
    for (int oc = 0; oc < kCout; ++oc) store(yp + oc * plane, acc[oc]);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int n, int height, int width,
           long long sn, long long sc, long long sh, long long sw, cudaStream_t s) {
  // above 48 KB of shared memory only after this opt-in (idempotent, cheap)
  cudaError_t err = cudaFuncSetAttribute(
      stem_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hout = (height - 1) / 2 + 1;  // (H + 2*3 - 7) / 2 + 1
  const int wout = (width - 1) / 2 + 1;
  const dim3 grid((wout + kTW - 1) / kTW, (hout + kTH - 1) / kTH, n);
  stem_conv_kernel<T><<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      height, width, hout, wout, sn, sc, sh, sw);
  return static_cast<int>(cudaGetLastError());
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
  if (dtype == 0) return launch<float>(x, w, y, n, height, width, sn, sc, sh, sw, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  const int hout = (height - 1) / 2 + 1, wout = (width - 1) / 2 + 1;
  const bool vec_store = wout % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid((wout + kGTW - 1) / kGTW, (hout + kGTH - 1) / kGTH, n);
  stem_conv_bf16_mma<<<grid, kGThreads, 0, s>>>(
      static_cast<const unsigned short*>(x), static_cast<const unsigned short*>(w),
      static_cast<__nv_bfloat16*>(y), height, width, hout, wout, sn, sc, sh, sw, vec_store);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
