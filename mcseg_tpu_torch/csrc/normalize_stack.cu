// Fused normalize/stack for Hopper (sm_90a): RGB + extra planes -> the
// normalized channel stack the trunk consumes.
//
// Replaces the Pallas TPU kernel mcseg_tpu/ops/pallas/normalize.py:84
// fused_normalize_stack (body _kernel at :54). It computes what that kernel
// computes, not its block structure:
//
//   out[b,h,w,c] = (x[b,h,sw,c] - mean[c]) / std[c],  sw = flip[b] ? W-1-w : w
//   x = concat(rgb / 255, extra)   (input_ch 3: rgb only; 1: extra only)
//
// Two additions to the TPU kernel's contract: a second instance takes RGB
// as float32 already in [0, 1] (scale 1 instead of 1/255), so the eval
// path whose decode size differs from the target size (resized RGB) stays
// on the kernel too; and input_ch 7 (RGB + HHA + the binarized boundary
// plane, E = 4), which the Pallas kernel refuses (normalize.py:49-50
// raises): there the function matched is the JAX package's
// ops/preprocess.py _normalize_stack for 7 (RGB and HHA statistics, then
// mean 0.5 and std 0.25 for the boundary plane). Its 14-byte bf16 pixels
// need nothing of their own: the output span leaves as one flat stream of
// 16-byte stores whatever the pixel size, with the unaligned head and
// tail handled as for every shape. Every value is computed with the division (not a
// reciprocal multiply), so bf16 results equal the plain PyTorch version and
// float32 ones are within an ulp of it.
//
// Bound: memory. Per pixel it reads 3 B of uint8 RGB (12 B as float) plus
// 4*E B of extra planes and writes input_ch values (4 B each as f32, 2 B as
// bf16): 27 B at the serving case (uint8 RGB + 3 HHA planes -> 6 x bf16).
// The card moves that only with many bytes in flight per SM, in 16-byte
// accesses, and with few enough instructions per byte that the SMs keep up.
// The design:
//
//   1. A block's unit of work is a contiguous span of pixels of one sample:
//      as many whole rows as 16 KB of source bytes hold, at least one (one
//      row of 640 px, 9.6 KB, at the serving case; several rows of narrower
//      inputs), or, for rows too long for 48 KB of shared memory, an equal
//      segment of one row. Its source spans (mirrored row by row when the
//      sample is flipped) are staged in shared memory by 16-byte cp.async
//      copies, all issued before the block waits. Blocks are small (256
//      threads, <= 32 registers, ~20 KB of shared memory at the serving
//      case), so 8 share an SM and their copies overlap one another's
//      compute and stores.
//   2. Each thread turns whole pixels into normalized values, with channel
//      indices known at compile time; the flip is a mirrored index into the
//      staged span. uint8 RGB has 256 values per channel: the block divides
//      those 768 once into a table while its copies are in flight, and
//      pixels look theirs up, which leaves 3 divisions per pixel (the HHA
//      planes) instead of 9. The values go to a shared-memory image of the
//      output span.
//   3. The output span, contiguous NHWC, leaves as one flat stream of
//      16-byte stores (8 bf16 or 4 f32 values per thread per step).
//
// Alignment: each span is staged at the same address modulo 16 in shared
// memory as in global memory, so its 16-byte-aligned interior moves as
// 16-byte copies and only the unaligned head and tail (< 16 B each) move
// element by element. Every shape and every input offset takes this one
// path. At the serving shape (W = 640, contiguous tensors from the
// allocator) every span is 16-byte aligned at both ends, so nothing moves
// element by element.
//
// The output is written NHWC-contiguous, which is an NCHW tensor in
// channels_last memory format: the cuDNN trunk takes it without a copy.

#include <algorithm>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 8;  // blocks per SM: ptxas keeps to 32 registers
constexpr int kMaxCh = 7;
constexpr int kSmemBudget = 48 * 1024;  // the default dynamic shared memory limit
constexpr int kUnitLoadBytes = 16 * 1024;  // source bytes of a multi-row unit, at most

struct MeanStd {
  float mean[kMaxCh];
  float std[kMaxCh];
};

// Bytes of shared memory for n elements of type T staged at any alignment:
// room for the up to 15 bytes of offset, rounded up to 16.
template <typename T>
__host__ __device__ constexpr int staged_bytes(int n) {
  return (n * static_cast<int>(sizeof(T)) + 15 + 15) & ~15;
}

// uint8 RGB takes its normalized values from a table of 3 x 256 floats.
template <typename RgbT, int C>
constexpr bool kLut = C != 1 && sizeof(RgbT) == 1;

// Source bytes per pixel, and shared memory for a unit of n_px pixels: the
// staged sources, the RGB table and the output image.
template <typename RgbT, int C, int E>
__host__ __device__ constexpr int src_bytes_per_px() {
  return (C != 1 ? 3 * static_cast<int>(sizeof(RgbT)) : 0) + 4 * E;
}

template <typename RgbT, typename OutT, int C, int E>
__host__ __device__ constexpr int smem_bytes(int n_px) {
  return (C != 1 ? staged_bytes<RgbT>(n_px * 3) : 0) +
         (E > 0 ? staged_bytes<float>(n_px * E) : 0) + (kLut<RgbT, C> ? 3 * 256 * 4 : 0) +
         staged_bytes<OutT>(n_px * C);
}

__device__ __forceinline__ float to01(uint8_t v) {
  return static_cast<float>(v) / 255.0f;
}
__device__ __forceinline__ float to01(float v) { return v; }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

// The split of a span of n elements of T at address a into an unaligned
// head [0, head), a 16-byte-aligned interior of nvec 16-byte words, and an
// unaligned tail [tail, n).
struct Split {
  int head, nvec, tail;
};

template <typename T>
__device__ __forceinline__ Split split16(const void* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uintptr_t end = a + static_cast<uintptr_t>(n) * sizeof(T);
  uintptr_t lo = (a + 15) & ~uintptr_t(15);
  uintptr_t hi = end & ~uintptr_t(15);
  if (lo > hi) lo = hi = end;  // no whole aligned word inside the span
  return {static_cast<int>((lo - a) / sizeof(T)), static_cast<int>((hi - lo) / 16),
          static_cast<int>((hi - a) / sizeof(T))};
}

// The head and the tail of a split hold fewer than 16 bytes each, so one
// element per thread copies them.
template <typename T>
__device__ __forceinline__ void copy_head_tail(T* dst, const T* src, const Split& s, int n) {
  static_assert(16 <= kThreads, "one pass must cover a head or a tail");
  const int i = threadIdx.x;
  if (i < s.head) dst[i] = src[i];
  if (s.tail + i < n) dst[s.tail + i] = src[s.tail + i];
}

// Starts the copy of src[0, n) into shared memory at buf + (src % 16) and
// returns where it lands; the caller waits (cp_async_wait_all) and syncs.
template <typename T>
__device__ __forceinline__ T* stage(unsigned char* buf, const T* __restrict__ src, int n) {
  T* dst = reinterpret_cast<T*>(buf + (reinterpret_cast<uintptr_t>(src) & 15));
  const Split s = split16<T>(src, n);
  for (int i = threadIdx.x; i < s.nvec; i += kThreads)
    cp_async16(dst + s.head + i * (16 / sizeof(T)), src + s.head + i * (16 / sizeof(T)));
  copy_head_tail(dst, src, s, n);
  return dst;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Writes src[0, n) (shared memory, same address modulo 16 as dst) to dst.
template <typename T>
__device__ __forceinline__ void write_out(T* __restrict__ dst, const T* src, int n) {
  const Split s = split16<T>(dst, n);
  constexpr int kVec = 16 / sizeof(T);
#pragma unroll 1  // unrolled, its 16-byte registers would set the kernel's count
  for (int i = threadIdx.x; i < s.nvec; i += kThreads)
    *reinterpret_cast<uint4*>(dst + s.head + i * kVec) =
        *reinterpret_cast<const uint4*>(src + s.head + i * kVec);
  copy_head_tail(dst, src, s, n);
}

// C = input_ch, E = extra channels (0, 1, 3 or 4); RgbT = uint8_t | float.
// Grid (units per sample, B). A unit is `rows` whole rows of the sample
// (rows > 1 only when n_seg == 1) or one segment of `seg` columns of a row
// (n_seg > 1); either way its pixels are contiguous in every tensor.
template <typename RgbT, typename OutT, int C, int E>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
normalize_stack_kernel(const RgbT* __restrict__ rgb, const float* __restrict__ extra,
                       const int32_t* __restrict__ flip, OutT* __restrict__ out, int H,
                       int W, int rows, int seg, int n_seg, MeanStd ms) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  const int hq = blockIdx.x / n_seg;
  const int h0 = hq * rows;
  const int w0 = (blockIdx.x - hq * n_seg) * seg;
  const int nrows = min(rows, H - h0);
  const int ncols = min(seg, W - w0);  // a row's width within the unit
  const int n = nrows * ncols;
  const bool flipped = flip[b] > 0;
  const int src0 = flipped ? W - w0 - ncols : w0;  // first source column
  const int64_t row = (static_cast<int64_t>(b) * H + h0) * W;

  unsigned char* buf = smem;
  const RgbT* rgb_s = nullptr;
  const float* extra_s = nullptr;
  if constexpr (C != 1) {
    rgb_s = stage(buf, rgb + (row + src0) * 3, n * 3);
    buf += staged_bytes<RgbT>(n * 3);
  }
  if constexpr (E > 0) {
    extra_s = stage(buf, extra + (row + src0) * E, n * E);
    buf += staged_bytes<float>(n * E);
  }
  [[maybe_unused]] float* lut = reinterpret_cast<float*>(buf);
  if constexpr (kLut<RgbT, C>) {  // while the copies are in flight
    for (int i = threadIdx.x; i < 3 * 256; i += kThreads) {
      const int c = i >> 8;  // selects, not an indexed read of the parameters
      const float mean = c == 0 ? ms.mean[0] : c == 1 ? ms.mean[1] : ms.mean[2];
      const float std = c == 0 ? ms.std[0] : c == 1 ? ms.std[1] : ms.std[2];
      lut[i] = (to01(static_cast<uint8_t>(i & 255)) - mean) / std;
    }
    buf += 3 * 256 * 4;
  }
  OutT* o = out + (row + w0) * C;
  OutT* ys = reinterpret_cast<OutT*>(buf + (reinterpret_cast<uintptr_t>(o) & 15));
  cp_async_wait_all();
  __syncthreads();

  // pixel i of the unit is column w of its row, so flipped it reads the
  // staged pixel i + ncols - 1 - 2w; w advances with i, with no division
  int w = threadIdx.x % ncols;
  const int step_w = kThreads % ncols;
#pragma unroll 1  // one pixel per step: its C values stay within 32 registers
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int s = flipped ? i + ncols - 1 - 2 * w : i;
    w += step_w;
    if (w >= ncols) w -= ncols;
    float y[C];
    if constexpr (C == 1) {
      y[0] = (extra_s[s] - ms.mean[0]) / ms.std[0];
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if constexpr (kLut<RgbT, C>)
          y[c] = lut[c * 256 + rgb_s[s * 3 + c]];
        else
          y[c] = (to01(rgb_s[s * 3 + c]) - ms.mean[c]) / ms.std[c];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) y[3 + e] = (extra_s[s * E + e] - ms.mean[3 + e]) / ms.std[3 + e];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) put(ys + i * C + c, y[c]);
  }
  __syncthreads();
  write_out(o, ys, n * C);
}

template <typename RgbT, typename OutT, int C, int E>
int launch(const void* rgb, const void* extra, const void* flip, void* out,
           int B, int H, int W, const MeanStd& ms, cudaStream_t stream) {
  constexpr int kBytesPerPx = src_bytes_per_px<RgbT, C, E>() + C * static_cast<int>(sizeof(OutT));
  constexpr int kMaxPx =
      (kSmemBudget - 3 * 32 - (kLut<RgbT, C> ? 3 * 256 * 4 : 0)) / kBytesPerPx;
  static_assert(smem_bytes<RgbT, OutT, C, E>(kMaxPx) <= kSmemBudget, "unit too large");
  int rows = 1, seg = W, n_seg = 1;
  if (W > kMaxPx) {  // segments of one row
    n_seg = (W + kMaxPx - 1) / kMaxPx;
    seg = (W + n_seg - 1) / n_seg;  // equal segments, each <= kMaxPx
  } else {  // whole rows: as many as kUnitLoadBytes of sources hold, at least one
    constexpr int kUnitPx = kUnitLoadBytes / src_bytes_per_px<RgbT, C, E>();
    rows = std::max(1, std::min(std::min(kUnitPx, kMaxPx) / W, H));
  }
  const int units = (H + rows - 1) / rows * n_seg;
  const dim3 grid(units, B);
  normalize_stack_kernel<RgbT, OutT, C, E>
      <<<grid, kThreads, smem_bytes<RgbT, OutT, C, E>(rows * seg), stream>>>(
          static_cast<const RgbT*>(rgb), static_cast<const float*>(extra),
          static_cast<const int32_t*>(flip), static_cast<OutT*>(out), H, W, rows, seg, n_seg,
          ms);
  return static_cast<int>(cudaGetLastError());
}

template <typename RgbT, typename OutT>
int dispatch_ch(const void* rgb, const void* extra, const void* flip,
                void* out, int B, int H, int W, int input_ch,
                const MeanStd& ms, cudaStream_t stream) {
  switch (input_ch) {
    case 3: return launch<RgbT, OutT, 3, 0>(rgb, extra, flip, out, B, H, W, ms, stream);
    case 6: return launch<RgbT, OutT, 6, 3>(rgb, extra, flip, out, B, H, W, ms, stream);
    case 4: return launch<RgbT, OutT, 4, 1>(rgb, extra, flip, out, B, H, W, ms, stream);
    case 1: return launch<RgbT, OutT, 1, 1>(rgb, extra, flip, out, B, H, W, ms, stream);
    case 7: return launch<RgbT, OutT, 7, 4>(rgb, extra, flip, out, B, H, W, ms, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point for ctypes. rgb: [B,H,W,3] uint8 (rgb_is_float=0) or float
// in [0,1] (rgb_is_float=1); extra: [B,H,W,E] float or null when E=0;
// flip: [B] int32; out: [B,H,W,input_ch] float (out_is_bf16=0) or bf16.
// All contiguous, at any element-aligned address. mean/std: host arrays of
// input_ch floats. Returns cudaGetLastError().
extern "C" int mcseg_normalize_stack(const void* rgb, int rgb_is_float,
                                     const void* extra, const void* flip,
                                     void* out, int out_is_bf16, int B, int H,
                                     int W, int input_ch, const float* mean,
                                     const float* std, void* stream) {
  if (input_ch < 1 || input_ch > kMaxCh || B <= 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  MeanStd ms;
  for (int c = 0; c < kMaxCh; ++c) {
    ms.mean[c] = c < input_ch ? mean[c] : 0.0f;
    ms.std[c] = c < input_ch ? std[c] : 1.0f;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rgb_is_float) {
    return out_is_bf16
        ? dispatch_ch<float, __nv_bfloat16>(rgb, extra, flip, out, B, H, W, input_ch, ms, s)
        : dispatch_ch<float, float>(rgb, extra, flip, out, B, H, W, input_ch, ms, s);
  }
  return out_is_bf16
      ? dispatch_ch<uint8_t, __nv_bfloat16>(rgb, extra, flip, out, B, H, W, input_ch, ms, s)
      : dispatch_ch<uint8_t, float>(rgb, extra, flip, out, B, H, W, input_ch, ms, s);
}
