// ResNet stem: the exact 7x7 / stride-2 / pad-3 convolution, 3 -> 64 channels.
//
// Replaces: handmvnet_tpu/ops/pallas/stem.py, _stem_kernel launched by
// stem_s2d_fused (a 2x2 space-to-depth im2col in VMEM and one [rows, 192] x
// [192, 64] matrix product per row tile, f32 accumulation).
//
// Shapes on the main path: x [8, 3, 256, 256] -> y [8, 64, 128, 128] at
// serving (2.47 GFLOP), x [40, ...] in a training microbatch, x [80, ...] at
// eval, x [5, ...] in infer.py. In bf16 a call moves 20 MB at x [8], 16.8 MB
// of it the NCHW output: 6.0 us at 3.35 TB/s against 2.5 us of tensor-core
// work at 989 TFLOP/s, so bf16 is bound by bytes, above all by the output
// write. In fp32 it moves 40 MB (11.9 us) against 15.0 us of 3xTF32 work (three
// TF32 products per f32 product at 495 TFLOP/s, mma.cuh): bound by operations.
//
// The design (stem_conv_bf16_wgmma, stem_conv_tf32x3_wgmma): an implicit GEMM
// on wgmma with the pixels as M and the 64 channels as N, C [pixels, 64] =
// im2col [pixels, K] x W^T [K, 64]. The weights are wgmma's B operand: each
// block reads them once (every load in flight at once), reorders them into
// the K order below, splits them (fp32) into TF32 hi and lo planes and stores
// them in shared memory as 128-byte-swizzled K-major panels (bf16 24 KB, fp32
// 80 KB). The im2col is wgmma's A operand from registers: each thread gathers
// its fragments from an input patch in shared memory (one 4-byte load a bf16
// register pair, one 8-byte load a pair of fp32 values), so the im2col is
// never written to shared memory. (As a shared-memory operand, the channels
// as M and the pixels as N, each element would be stored once and read once
// more, and a 256-pixel fp32 tile in hi and lo would take 304 KB at K = 152.)
// K order: the taps (kh, kw, c) as 7 runs of 22 elements, one input row of the
// window each: a padded tap, then 7 columns x 3 channels, contiguous in the
// NHWC image, so that no pair spans two rows and every pair starts on an even
// element of the image row. K = 154, padded to 160 (8% more products than the
// 147 taps; the TPU kernel's s2d order, the same layout over an 8 x 8 window,
// is K = 192: kWin = 8 below, 4-11% slower in bf16 and 10-17% in fp32). A padded tap has
// a zero weight and its input is zeroed too (a mask a pair, from a per-lane
// table of k steps), so an inf or NaN in the image cannot leak in through it.
// fp32 permutes k within each step of 8 (position t stands for k = 2t, t + 4
// for 2t + 1, mma.cuh), in the weights' planes and the gathers alike, so that
// an A fragment's two values of a row are neighbours; the three products hi_a
// lo_b, lo_a hi_b, hi_a hi_b go into one accumulator (m64n64k8 each), the
// weights' lo rounded to TF32 (split_tf32), the image's left for the tensor
// core to truncate (split_hi, mma.cuh). Against float64 that is as accurate as
// the lo rounded and as PR 16's kernel (RMS 6.9e-7 against 6.9e-7 and 6.6e-7
// at x [8] of unit inputs; F.conv2d in fp32 1.3e-7) and 3-7% faster than
// rounding; the choice moves only the result's last bits (PERF.md).
// Blocks are persistent: one a SM, four warpgroups a block, each walking
// output tiles of 2 x 32 pixels (one m64 product; 4 x 32 in two warpgroups and
// 8 x 32 were slower in both dtypes). A warpgroup's next patch is in flight
// by TMA while it computes (an NHWC image viewed as [n, h, 3w], boxes of 216
// (bf16) or 212 (fp32) x 9 elements starting on 16 bytes, zero-filled outside
// the image, which is the conv's padding); step s + 1's values are loaded
// while step s's wgmmas run and become fragments in the other of two register
// buffers once step s - 1's are done (wgmma.wait_group 1); the tile leaves by
// a TMA store (4-D map [n, ho, 64, wo] in the order (x, channel, row, image),
// box 32 x 64 x 2, staged as [row][channel][x] in the store's swizzle, 128 B
// fp32 and 64 B bf16: conflict-free scalar stores) that overlaps the next
// tile. Where TMA cannot take a tensor (input strides other than an NHWC
// image's, rows or bases off 16 bytes; output rows off 16 bytes) the same
// kernel copies with its threads instead (hmv_stem_routes says which).
// Shared memory: bf16 24 KB weights + 4 x (8 KB staging + 2 x 4 KB patches) =
// 89 KB; fp32 80 KB + 4 x (16 KB + 2 x 8 KB) = 209 KB. fp32 fits 128 registers
// a thread with a few bytes spilled (chip_smoke.py prints ptxas's count).
// What holds it (kernel_variants.py on an H100 SXM at 700 W, PERF.md): fp32
// at x [40] takes 124 us against 81.5 us of 3xTF32 products at peak (K = 160)
// and 87.8 us without its products: the gathers, the epilogue and the output
// (4 bytes a value) overlap the products only in part. bf16 pays ~6 us of
// fixed cost (the weights, the first patch, the last stores), then ~1.0 us an
// image against the bound's 0.74.
//
// Input strides are free; weights are contiguous OIHW and the output is
// contiguous NCHW.

#include <cuda.h>

#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kCin = 3;
constexpr int kCout = 64;                  // wgmma's n
constexpr int kWin = 7;                    // window rows and columns gathered (8: the s2d order)
constexpr int kBf16Rows = 2;               // output rows of a bf16 tile
constexpr int kBf16Groups = 4;             // bf16 warpgroups a block
constexpr int kF32Rows = 2;                // output rows of an fp32 tile
constexpr int kF32Groups = 4;              // fp32 warpgroups a block
constexpr int kStages = 2;                 // input patches a warpgroup holds
constexpr int kCols = 32;                  // output columns of a tile
constexpr int kOrigin = kWin - 4;          // a window's first input row and column: 2 o - kOrigin
constexpr int kRun = (3 * kWin + 1) / 2 * 2;  // elements of one window row, padded to pairs
constexpr int kFront = kRun - 3 * kWin;    // padded taps at the front of a run: 1 (7) or 0 (8)
constexpr int kTaps = kWin * kRun;         // K before rounding to whole k steps
constexpr int kPanel = 64 * 128;           // one swizzled panel of the weights: 64 rows x 128 B

template <typename T>
struct Cfg;
template <>
struct Cfg<unsigned short> {  // bf16
  static constexpr int kElt = 2, kStepK = 16, kRows = kBf16Rows, kGroups = kBf16Groups, kPlanes = 1;
};
template <>
struct Cfg<float> {
  static constexpr int kElt = 4, kStepK = 8, kRows = kF32Rows, kGroups = kF32Groups, kPlanes = 2;
};

// shared memory of a block: the weights' planes, then each warpgroup's staged
// output tile and its patches, then the table of k steps. A patch row starts
// on 16 bytes (TMA's box starts there), kShift elements before the run of the
// tile's first pixel (its windows start at 6 ox - 3 kOrigin - kFront in the
// image row of 3 w elements, 6 ox0 a multiple of 16 bytes), so every pair of a
// run sits on its own 4 (bf16) or 8 (fp32) bytes
template <typename T>
struct Layout {
  using C = Cfg<T>;
  static constexpr int kAlign = 16 / C::kElt;  // elements of 16 bytes
  static constexpr int kShift = (kAlign - (3 * kOrigin + kFront) % kAlign) % kAlign;
  static constexpr int kPatchRow = (kShift + 6 * (kCols - 1) + kRun + kAlign - 1) / kAlign * kAlign;
  static constexpr int kK = (kTaps + C::kStepK - 1) / C::kStepK * C::kStepK;
  static constexpr int kSteps = kK / C::kStepK;
  static constexpr int kPanels = (kK * C::kElt + 127) / 128;
  static constexpr int kPlaneBytes = kPanels * kPanel;
  static constexpr int kPatchRows = 2 * C::kRows + kWin - 2;
  static constexpr int kPatchBytes = kPatchRows * kPatchRow * C::kElt;
  static constexpr int kPatchStride = (kPatchBytes + 1023) / 1024 * 1024;
  static constexpr int kStageBytes = C::kRows * kCout * kCols * C::kElt;
  static constexpr int kGroupBytes = kStageBytes + kStages * kPatchStride;
  static constexpr int kTable = C::kPlanes * kPlaneBytes + C::kGroups * kGroupBytes;
  static constexpr int kThreads = C::kGroups * 128;
  static constexpr int kBytes = kTable + kSteps * 4 * 16;
  static constexpr int kMT = C::kRows / 2;  // m64 products of a tile: 2 rows x 32 columns each
};

struct StemArgs {
  const void* x;
  const void* w;
  void* y;
  long long sn, sc, sh, sw;
  int height, width, hout, wout, tiles_x, tiles_y, tiles;
  int load_tma, store_tma;
};

// k (the K order: run r = k / kRun, element e = k % kRun of the window row,
// whose first kFront elements are padding) holds a tap of the 7 x 7 kernel
__device__ __forceinline__ bool tap_valid(int k) {
  const int r = k / kRun, e = k % kRun - kFront;
  return k < kTaps && r >= kWin - 7 && e >= 3 * (kWin - 7);
}

// byte offset of staged output element (row R = output row * 64 + channel,
// column x) in the TMA store's swizzle: 128-byte rows with the 128-byte
// swizzle (fp32) or 64-byte rows with the 64-byte swizzle (bf16)
template <typename T>
__device__ __forceinline__ int stage_offset(int row, int x) {
  if (sizeof(T) == 4) return row * 128 + ((((x >> 2) ^ row) & 7) << 4) + (x & 3) * 4;
  const int o = row * 64 + x * 2;
  return o ^ (((o >> 7) & 3) << 4);
}

// d (+)= A B over 64 x 64 x 16, A (64 pixels x 16 k) in registers, B (64
// channels x 16 k) K-major in shared memory; d is overwritten unless accumulate
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// the same over 64 x 64 x 8 in TF32
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// 3xTF32 over 64 x 64 x 8: hi_a lo_b, lo_a hi_b, hi_a hi_b into one accumulator
__device__ __forceinline__ void wgmma_tf32x3(float (&d)[32], const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4], uint64_t bh, uint64_t bl,
                                             int accumulate) {
  wgmma_tf32(d, ah, bl, accumulate);
  wgmma_tf32(d, al, bh, 1);
  wgmma_tf32(d, ah, bh, 1);
}

// one m64 product's values of a k step from the patch (q: this thread's row
// g; row g + 8 is 8 pixels, 48 elements, on), each pair one load: bf16 e =
// {off, mask, off + 8, mask + 8}, v = (g, k 2t..2t+1), (g+8, ..), (g, k
// 2t+8..), (g+8, ..); fp32 e = {off, mask of k 2t, mask of 2t + 1}, v = (g, k
// 2t), (g, 2t + 1), (g+8, 2t), (g+8, 2t + 1)
__device__ __forceinline__ void load_step(uint32_t (&v)[4], const unsigned short* q, int4 e) {
  v[0] = *reinterpret_cast<const uint32_t*>(q + e.x);
  v[1] = *reinterpret_cast<const uint32_t*>(q + 48 + e.x);
  v[2] = *reinterpret_cast<const uint32_t*>(q + e.z);
  v[3] = *reinterpret_cast<const uint32_t*>(q + 48 + e.z);
}

__device__ __forceinline__ void load_step(uint32_t (&v)[4], const float* q, int4 e) {
  const uint2 a = *reinterpret_cast<const uint2*>(q + e.x);
  const uint2 b = *reinterpret_cast<const uint2*>(q + 48 + e.x);
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

// the A fragments from them, padded taps zeroed: bf16 a0..a3 as loaded; fp32
// a0 (g, position t = k 2t), a1 (g+8, t), a2 (g, t + 4 = k 2t + 1), a3 (g+8,
// t + 4), split into TF32 hi and lo (lo left for the tensor core to truncate)
__device__ __forceinline__ void finish_bf16(uint32_t (&f)[4], const uint32_t (&v)[4], int4 e) {
  f[0] = v[0] & e.y, f[1] = v[1] & e.y, f[2] = v[2] & e.w, f[3] = v[3] & e.w;
}

__device__ __forceinline__ void finish_f32(uint32_t (&h)[4], uint32_t (&l)[4],
                                           const uint32_t (&v)[4], int4 e) {
  split_hi(__uint_as_float(v[0] & e.y), h[0], l[0]);
  split_hi(__uint_as_float(v[2] & e.y), h[1], l[1]);
  split_hi(__uint_as_float(v[1] & e.z), h[2], l[2]);
  split_hi(__uint_as_float(v[3] & e.z), h[3], l[3]);
}

// the weights into the B planes: every load of the OIHW weights in flight at
// once, the planes zeroed meanwhile, then each tap stored at its place: row
// ch, k (fp32: its position in the step of 8, k 2i at i and 2i + 1 at i + 4),
// swizzled
template <typename T>
__device__ void stage_weights(unsigned char* w_s, const T* w) {
  using L = Layout<T>;
  constexpr int kThreads = L::kThreads;
  constexpr int kW = kCout * kCin * 49, kPer = (kW + kThreads - 1) / kThreads;
  T v[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    v[j] = i < kW ? w[i] : T(0);
  }
  for (int i = threadIdx.x; i < Cfg<T>::kPlanes * L::kPlaneBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(w_s)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i >= kW) break;
    const int ch = i / 147, c = i / 49 % 3, kh = i / 7 % 7, kw = i % 7;
    const int k = (kh + kWin - 7) * kRun + kFront + 3 * (kw + kWin - 7) + c;
    const int q = sizeof(T) == 4 ? (k & ~7) + (k & 1 ? 4 : 0) + ((k & 7) >> 1) : k;
    const int byte = q * Cfg<T>::kElt;
    const int off = (byte / 128) * kPanel + ch * 128 + ((((byte >> 4) & 7) ^ (ch & 7)) << 4) +
                    (byte & 15);
    if constexpr (sizeof(T) == 4) {
      uint32_t hi, lo;
      split_tf32(v[j], hi, lo);
      *reinterpret_cast<uint32_t*>(w_s + off) = hi;
      *reinterpret_cast<uint32_t*>(w_s + L::kPlaneBytes + off) = lo;
    } else {
      *reinterpret_cast<unsigned short*>(w_s + off) = v[j];
    }
  }
}

// the table of k steps: entry (step s, lane quad t) gives the patch offset of
// the pair at k = s * kStepK + 2t (and, bf16, + 8) and the masks that zero its
// padded taps: bf16 {off, mask, off + 8, mask + 8} (a mask a register of two),
// fp32 {off, mask of k, mask of k + 1, 0}
template <typename T>
__device__ void stage_table(int4* tab_s) {
  using L = Layout<T>;
  auto entry = [](int k, int& off, bool& v0, bool& v1) {  // k: the first of a pair
    v0 = tap_valid(k), v1 = tap_valid(k + 1);
    off = v0 || v1 ? (k / kRun) * L::kPatchRow + k % kRun : 0;
  };
  for (int i = threadIdx.x; i < L::kSteps * 4; i += L::kThreads) {
    const int k = (i / 4) * Cfg<T>::kStepK + 2 * (i % 4);
    int off0, off1;
    bool a0, a1, b0, b1;
    entry(k, off0, a0, a1);
    if constexpr (sizeof(T) == 4) {
      tab_s[i] = make_int4(off0, a0 ? -1 : 0, a1 ? -1 : 0, 0);
    } else {
      entry(k + 8, off1, b0, b1);
      tab_s[i] = make_int4(off0, (a0 ? 0xFFFF : 0) | (a1 ? 0xFFFF0000 : 0), off1,
                           (b0 ? 0xFFFF : 0) | (b1 ? 0xFFFF0000 : 0));
    }
  }
}

struct TileAt {
  int n, oy0, ox0;
};

__device__ __forceinline__ TileAt tile_at(const StemArgs& a, int tile, int rows) {
  const int tx = tile % a.tiles_x, rest = tile / a.tiles_x;
  return {rest / a.tiles_y, (rest % a.tiles_y) * rows, tx * kCols};
}

// element of the image row (3 w elements: columns x channels) where a tile's
// patch rows start
template <typename T>
__device__ __forceinline__ int patch_start(const TileAt& at) {
  return 6 * at.ox0 - 3 * kOrigin - kFront - Layout<T>::kShift;
}

// the input patch of a tile by threads, as TMA lays it out: zeros outside the image
template <typename T>
__device__ void fill_patch(T* dst, const StemArgs& a, const TileAt& at, int gt) {
  using L = Layout<T>;
  const T* xn = static_cast<const T*>(a.x) + at.n * a.sn;
  const int ih0 = 2 * at.oy0 - kOrigin, e0 = patch_start<T>(at) + 48;  // + 48: e0 > 0
  for (int i = gt; i < L::kPatchRows * L::kPatchRow; i += 128) {
    const int row = i / L::kPatchRow, e = e0 + i % L::kPatchRow, c = e % 3;
    const int ih = ih0 + row, iw = e / 3 - 16;
    const bool in = ih >= 0 && ih < a.height && iw >= 0 && iw < a.width;
    dst[i] = in ? xn[c * a.sc + ih * a.sh + iw * a.sw] : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void stem_body(const CUtensorMap* xm, const CUtensorMap* ym,
                                          const StemArgs& a) {
  using C = Cfg<T>;
  using L = Layout<T>;
  constexpr int kMT = L::kMT;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[C::kGroups][kStages];
  unsigned char* w_s = aligned_smem(smem_raw);
  const int tid = threadIdx.x, grp = tid / 128, gt = tid % 128, warp = gt / 32;
  const int g = (tid & 31) >> 2, t = tid & 3;
  const bool lead = gt == 0;
  unsigned char* stage_s = w_s + C::kPlanes * L::kPlaneBytes + grp * L::kGroupBytes;
  unsigned char* patch_s = stage_s + L::kStageBytes;
  const int4* tab_s = reinterpret_cast<const int4*>(w_s + L::kTable);

  // the first patches in flight before the weights are staged
  const int stride = gridDim.x * C::kGroups;
  auto issue = [&](int tile, int buf) {
    const TileAt at = tile_at(a, tile, C::kRows);
    mbar_expect_tx(&bars[grp][buf], L::kPatchBytes);
    tma_load_3d(patch_s + buf * L::kPatchStride, xm, &bars[grp][buf], patch_start<T>(at),
                2 * at.oy0 - kOrigin, at.n);
  };
  int tile = blockIdx.x * C::kGroups + grp;
  if (lead) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[grp][s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (a.load_tma)
      for (int s = 0; s < kStages - 1; ++s)
        if (tile + s * stride < a.tiles) issue(tile + s * stride, s);
  }
  stage_table<T>(reinterpret_cast<int4*>(w_s + L::kTable));
  stage_weights(w_s, static_cast<const T*>(a.w));
  fence_proxy_async();  // the weights, written by ordinary stores, are read by wgmma
  __syncthreads();

  // this thread's A rows in a patch: m64 product mt covers output rows 2 mt,
  // 2 mt + 1; warp w its row w / 2, columns 16 (w % 2) + g (a0, a2) and + 8
  // (a1, a3), whose windows start 2 rows x 6 elements a pixel apart
  constexpr int kPatchRow = L::kPatchRow;
  const int pix = 2 * (warp / 2) * kPatchRow + 6 * (16 * (warp % 2) + g) + L::kShift;
  float acc[kMT][32];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;

  for (int it = 0; tile < a.tiles; ++it, tile += stride) {
    const int buf = it % kStages;
    const TileAt at = tile_at(a, tile, C::kRows);
    T* patch = reinterpret_cast<T*>(patch_s + buf * L::kPatchStride);
    if (a.load_tma) {
      const int ahead = tile + (kStages - 1) * stride;
      if (lead && ahead < a.tiles) issue(ahead, (it + kStages - 1) % kStages);
      mbar_wait(&bars[grp][buf], (it / kStages) & 1);
    } else {
      fill_patch(patch, a, at, gt);
      named_sync(1 + grp, 128);
    }
    const T* p = patch + pix;

    // k steps: step s + 1's values are loaded while step s's products run,
    // and become fragments in one of two register buffers once step s - 1's
    // products, which read the other, are done
    uint32_t v[kMT][4];
    int4 e = tab_s[t];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) load_step(v[mt], p + mt * 4 * kPatchRow, e);
    if constexpr (sizeof(T) == 2) {
      uint32_t af[2][kMT][4];
#pragma unroll
      for (int s = 0; s < L::kSteps; ++s) {
        uint32_t(&f)[kMT][4] = af[s & 1];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) finish_bf16(f[mt], v[mt], e);
        wgmma_fence();
        const uint64_t b = sw128_desc(w_s + (s / 4) * kPanel + (s % 4) * 32, 16, 1024);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) wgmma_bf16(acc[mt], f[mt], b, s > 0);
        wgmma_commit();
        if (s + 1 < L::kSteps) {
          e = tab_s[(s + 1) * 4 + t];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) load_step(v[mt], p + mt * 4 * kPatchRow, e);
        }
        wgmma_wait<1>();
      }
    } else {
      uint32_t ah[2][kMT][4], al[2][kMT][4];
#pragma unroll
      for (int s = 0; s < L::kSteps; ++s) {
        uint32_t(&h)[kMT][4] = ah[s & 1];
        uint32_t(&l)[kMT][4] = al[s & 1];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) finish_f32(h[mt], l[mt], v[mt], e);
        wgmma_fence();
        const unsigned char* wb = w_s + (s / 4) * kPanel + (s % 4) * 32;
        const uint64_t bh = sw128_desc(wb, 16, 1024), bl = sw128_desc(wb + L::kPlaneBytes, 16, 1024);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) wgmma_tf32x3(acc[mt], h[mt], l[mt], bh, bl, s > 0);
        wgmma_commit();
        if (s + 1 < L::kSteps) {
          e = tab_s[(s + 1) * 4 + t];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) load_step(v[mt], p + mt * 4 * kPatchRow, e);
        }
        wgmma_wait<1>();
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_reg(acc[mt][i]);

    // epilogue: the previous tile's store has read the staging; stage this
    // one as [row][channel][column] (value i of product mt: pixel 64 mt + 16
    // warp + g (+8 for i % 4 >= 2), channel 8 (i / 4) + 2t + i % 2), then one
    // TMA store (or the threads' stores) while the next tile is computed
    if (a.store_tma && lead) bulk_wait_read0();
    named_sync(1 + grp, 128);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int px = 64 * mt + 16 * warp + g + 8 * ((i >> 1) & 1);
        const int row = (px / kCols) * kCout + 8 * (i >> 2) + 2 * t + (i & 1);
        unsigned char* dst = stage_s + stage_offset<T>(row, px % kCols);
        if constexpr (sizeof(T) == 4)
          *reinterpret_cast<float*>(dst) = acc[mt][i];
        else
          *reinterpret_cast<__nv_bfloat16*>(dst) = __float2bfloat16_rn(acc[mt][i]);
      }
    if (a.store_tma) {
      fence_proxy_async();
      named_sync(1 + grp, 128);
      if (lead) {
        tma_store_4d(ym, stage_s, at.ox0, 0, at.oy0, at.n);
        bulk_commit();
      }
    } else {
      named_sync(1 + grp, 128);
      T* yn = static_cast<T*>(a.y) + static_cast<long long>(at.n) * kCout * a.hout * a.wout;
      for (int i = gt; i < C::kRows * kCout * kCols; i += 128) {
        const int x = i % kCols, row = i / kCols, oy = at.oy0 + row / kCout, ox = at.ox0 + x;
        if (oy < a.hout && ox < a.wout)
          yn[(static_cast<long long>(row % kCout) * a.hout + oy) * a.wout + ox] =
              *reinterpret_cast<const T*>(stage_s + stage_offset<T>(row, x));
      }
    }
  }
  // the staging may go once the last store has read it; the writes complete
  // with the grid
  if (a.store_tma && lead) bulk_wait_read0();
}

__global__ void __launch_bounds__(Layout<unsigned short>::kThreads, 1)
stem_conv_bf16_wgmma(__grid_constant__ const CUtensorMap xm, __grid_constant__ const CUtensorMap ym,
                     const StemArgs a) {
  stem_body<unsigned short>(&xm, &ym, a);
}

__global__ void __launch_bounds__(Layout<float>::kThreads, 1)
stem_conv_tf32x3_wgmma(__grid_constant__ const CUtensorMap xm,
                       __grid_constant__ const CUtensorMap ym, const StemArgs a) {
  stem_body<float>(&xm, &ym, a);
}

// ---- host ------------------------------------------------------------------

// which copies TMA takes (bit 0 the input patches, bit 1 the output tiles):
// the input as an NHWC image (channel stride 1, pixel stride 3) whose rows and
// images start on 16 bytes; the output's rows on 16 bytes
int routes(int elt, int n, int height, int wout, long long sn, long long sc, long long sh,
           long long sw, const void* x, const void* y) {
  const bool load = sc == 1 && sw == 3 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    (height == 1 || (sh > 0 && sh * elt % 16 == 0)) &&
                    (n == 1 || (sn > 0 && sn * elt % 16 == 0));
  const bool store = wout * elt % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  return (load ? 1 : 0) | (store ? 2 : 0);
}

// the input as [n, height, 3 width] (rows of interleaved channels), boxes of a
// tile's patch; the output as [n, hout, 64, wout] in the order (x, channel,
// row, image), boxes of a tile, in the staging's swizzle. A dimension of
// extent 1 takes a stride of 16 bytes (it is never stepped).
bool encode_maps(CUtensorMap* xm, CUtensorMap* ym, const StemArgs& a, int n, int elt, int rows,
                 int patch_row, int patch_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const CUtensorMapDataType type =
      elt == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (a.load_tma) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(3) * a.width,
                                static_cast<cuuint64_t>(a.height), static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[2] = {a.height == 1 ? 16 : static_cast<cuuint64_t>(a.sh) * elt,
                                   n == 1 ? 16 : static_cast<cuuint64_t>(a.sn) * elt};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(patch_row),
                               static_cast<cuuint32_t>(patch_rows), 1};
    if (fn(xm, type, 3, const_cast<void*>(a.x), dims, strides, box, unit,
           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
           CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
  }
  if (a.store_tma) {
    const cuuint64_t plane = static_cast<cuuint64_t>(a.hout) * a.wout * elt;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.wout), kCout,
                                static_cast<cuuint64_t>(a.hout), static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[3] = {plane, a.hout == 1 ? 16 : static_cast<cuuint64_t>(a.wout) * elt,
                                   n == 1 ? 16 : kCout * plane};
    const cuuint32_t box[4] = {kCols, kCout, static_cast<cuuint32_t>(rows), 1};
    if (fn(ym, type, 4, a.y, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
           elt == 4 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
           CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
  }
  return true;
}

// persistent: as many blocks as fit on the card at once (one a SM), at most
// one a pair of tiles
template <typename T, typename Kernel>
int launch(Kernel kernel, StemArgs a, int n, cudaStream_t s) {
  using L = Layout<T>;
  constexpr int kSmem = kAlignSlack + L::kBytes;
  static_assert(kSmem <= 232448, "shared memory of a block");
  a.tiles_x = (a.wout + kCols - 1) / kCols;
  a.tiles_y = (a.hout + Cfg<T>::kRows - 1) / Cfg<T>::kRows;
  a.tiles = n * a.tiles_x * a.tiles_y;
  CUtensorMap xm{}, ym{};
  if (!encode_maps(&xm, &ym, a, n, Cfg<T>::kElt, Cfg<T>::kRows, L::kPatchRow, L::kPatchRows))
    return cudaErrorInvalidValue;
  // above 48 KB of shared memory only after this opt-in (idempotent, cheap)
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int per_sm = 0;  // blocks a SM: one query a kernel
  int dev = 0, sms = 0;
  if ((per_sm == 0 && (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                           &per_sm, kernel, L::kThreads, kSmem)) != cudaSuccess) ||
      (err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  constexpr int kGroups = Cfg<T>::kGroups;
  const int blocks = std::max(1, std::min((a.tiles + kGroups - 1) / kGroups, sms * per_sm));
  kernel<<<blocks, L::kThreads, kSmem, s>>>(xm, ym, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The copies a call would take (see routes): bit 0 the input by TMA, bit 1
// the output by TMA; otherwise the kernel's threads copy.
int hmv_stem_routes(int dtype, int n, int height, int width, long long sn, long long sc,
                    long long sh, long long sw, const void* x, const void* y) {
  return routes(dtype == 0 ? 4 : 2, n, height, (width - 1) / 2 + 1, sn, sc, sh, sw, x, y);
}

// x: [n, 3, height, width] with element strides (sn, sc, sh, sw); w: contiguous
// [64, 3, 7, 7]; y: contiguous [n, 64, (height+1)/2, (width+1)/2].
// dtype: 0 = float32, 1 = bfloat16. Returns cudaErrorInvalidValue for what the
// kernels do not take (or a tensor map the driver refuses), else the launch's
// cudaGetLastError().
int hmv_stem_conv(const void* x, const void* w, void* y, int dtype, int n, int height, int width,
                  long long sn, long long sc, long long sh, long long sw, void* stream) {
  if (n < 1 || n > 65535 || height < 1 || width < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  StemArgs a{x, w, y, sn, sc, sh, sw, height, width, (height - 1) / 2 + 1, (width - 1) / 2 + 1};
  const int r = hmv_stem_routes(dtype, n, height, width, sn, sc, sh, sw, x, y);
  a.load_tma = r & 1;
  a.store_tma = (r >> 1) & 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(stem_conv_tf32x3_wgmma, a, n, s)
                    : launch<unsigned short>(stem_conv_bf16_wgmma, a, n, s);
}

}  // extern "C"
