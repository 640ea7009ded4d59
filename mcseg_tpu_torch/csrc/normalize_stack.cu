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
// One addition to the TPU kernel's contract: a second instance takes RGB as
// float32 already in [0, 1] (scale 1 instead of 1/255), so the eval path
// whose decode size differs from the target size (resized RGB) stays on
// the kernel too.
//
// Bound: memory. Per pixel it reads 3 B of uint8 RGB (12 B as float) plus
// 4*E B of extra planes and writes input_ch values (4 B each as f32, 2 B as
// bf16); no arithmetic intensity to speak of. Design: one thread per output
// pixel over a (W-tiles, H, B) grid, so the flip is a per-block column
// remap and the whole stack is written in one pass with nothing staged in
// shared memory. The output is written NHWC-contiguous, which is an NCHW
// tensor in channels_last memory format: the cuDNN trunk takes it without a
// copy. Division (not a reciprocal multiply) keeps the result bitwise equal
// to the plain PyTorch version in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCh = 6;

struct MeanStd {
  float mean[kMaxCh];
  float std[kMaxCh];
};

__device__ __forceinline__ float to01(uint8_t v) {
  return static_cast<float>(v) / 255.0f;
}
__device__ __forceinline__ float to01(float v) { return v; }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// C = input_ch, E = extra channels (0, 1 or 3); RgbT = uint8_t | float.
template <typename RgbT, typename OutT, int C, int E>
__global__ void __launch_bounds__(kThreads)
normalize_stack_kernel(const RgbT* __restrict__ rgb,
                       const float* __restrict__ extra,
                       const int32_t* __restrict__ flip,
                       OutT* __restrict__ out, int H, int W, MeanStd ms) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int sw = flip[b] > 0 ? W - 1 - w : w;
  const int64_t row = (static_cast<int64_t>(b) * H + h) * W;
  const int64_t src = row + sw;

  float x[C];
  if constexpr (C == 1) {
    x[0] = extra[src];
  } else {
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = to01(rgb[src * 3 + c]);
#pragma unroll
    for (int e = 0; e < E; ++e) x[3 + e] = extra[src * E + e];
  }
  OutT* o = out + (row + w) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) store(o + c, (x[c] - ms.mean[c]) / ms.std[c]);
}

template <typename RgbT, typename OutT, int C, int E>
void launch(const void* rgb, const void* extra, const void* flip, void* out,
            int B, int H, int W, const MeanStd& ms, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, B);
  normalize_stack_kernel<RgbT, OutT, C, E><<<grid, kThreads, 0, stream>>>(
      static_cast<const RgbT*>(rgb), static_cast<const float*>(extra),
      static_cast<const int32_t*>(flip), static_cast<OutT*>(out), H, W, ms);
}

template <typename RgbT, typename OutT>
int dispatch_ch(const void* rgb, const void* extra, const void* flip,
                void* out, int B, int H, int W, int input_ch,
                const MeanStd& ms, cudaStream_t stream) {
  switch (input_ch) {
    case 3: launch<RgbT, OutT, 3, 0>(rgb, extra, flip, out, B, H, W, ms, stream); break;
    case 6: launch<RgbT, OutT, 6, 3>(rgb, extra, flip, out, B, H, W, ms, stream); break;
    case 4: launch<RgbT, OutT, 4, 1>(rgb, extra, flip, out, B, H, W, ms, stream); break;
    case 1: launch<RgbT, OutT, 1, 1>(rgb, extra, flip, out, B, H, W, ms, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point for ctypes. rgb: [B,H,W,3] uint8 (rgb_is_float=0) or float
// in [0,1] (rgb_is_float=1); extra: [B,H,W,E] float or null when E=0;
// flip: [B] int32; out: [B,H,W,input_ch] float (out_is_bf16=0) or bf16.
// mean/std: host arrays of input_ch floats. Returns cudaGetLastError().
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
