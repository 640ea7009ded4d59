// The heads' fixed-bilinear upsample for Hopper (sm_90a), forward and its
// gradient with respect to the input: the depthwise
// ConvTranspose2d(C, C, 2f, stride f, padding (ph, pw), groups C) with FCN's
// fill_up_weights taps, which ops/upsample.py upsample_bilinear_convt runs.
//
// Replaces no TPU kernel: the JAX package leaves this op to XLA as a banded
// matmul (mcseg_tpu/ops/upsample.py:70). It replaces cuDNN's grouped direct
// transposed convolution, which reached ~0.3% of the card's memory bound at
// the heads' shapes, and the 16x16 taps tensor that each call built on the
// host and copied to the card, a copy the host waited for.
//
// Layout. x is [N, Hi, Wi, C] and y is [N, Ho, Wo, C], both contiguous: a
// channels_last NCHW tensor as it lies (N = batch), or a contiguous NCHW one
// as [B*C, Hi, Wi, 1]. Ho = (Hi + 1) f - 2 ph, Wo = (Wi + 1) f - 2 pw, as
// torch gives them.
//
// What it computes. Output row o reads input rows q = (o + ph) / f with the
// tap w(r) and q - 1 with w(r + f), r = (o + ph) % f; columns alike. w(t) =
// 1 - |t/f - c|, c = (2f - 1 - f % 2) / (2f), is bilinear_kernel's formula,
// worked out in double as numpy does. A row or column outside the input
// adds zero (a transposed convolution, no edge clamp). The convolution's
// 2-D tap is w(t) w(u): for f <= 8 each such product is exact in bf16, fp16,
// float and double, so the separable sums below compute the convolution's
// function; they accumulate in float (double for double) and round once to
// the output's dtype.
//
// Bound: memory. Forward reads x once and writes y once; y is f*f = 64
// times x at f = 8 (590 MB of bf16 at the training cell's batch 24 against
// 9 MB), so the least time is y's bytes at 3.35 TB/s. Backward has the same
// bytes the other way: it reads dy once and writes dx once.
//
//   Forward, output-stationary. A block takes kGroups consecutive q (the f
//   output rows that share one q, each), for one sample, and a span of
//   kThreads 16-byte words of a row. Each thread keeps its word's
//   elements' horizontal blends of input rows q - 1 and q in registers
//   (reads of x from L1/L2: x is 1/64 of the bytes; each row's blend is
//   worked out once and carried to the next q), then writes its word in
//   each of the f rows with one streamed 16-byte store: two multiply-adds
//   an element, neighbouring threads at neighbouring addresses. In
//   channels_last a row is Wo*C contiguous elements, so the words are
//   aligned for any C whenever Wo*C*sizeof(T) is a multiple of 16 (19 and
//   40 classes, 1 for the aux heads, at the heads' widths); a row that is
//   not aligned is written element by element.
//
//   Backward, input-stationary. A block takes R input rows and J input
//   columns, all C channels, and streams down the (R + 1) f rows of dy they
//   read. Each thread owns two 16-byte words of the block's row segment,
//   the same in every row, and keeps kAhead rows of them in flight in
//   registers (plain 16-byte loads, element loads where rows are not
//   16-byte aligned; no staging, no barrier per row). It
//   reduces the 2f x 2f window separably, along H first: each row's words,
//   times the row's two taps, go into float registers that hold the
//   vertical sums of the two input rows the row feeds. When the rows move
//   past an input row, its sums go to shared memory once and each thread
//   reduces them along W (2f taps) for two neighbouring columns of one
//   channel, whose windows share f columns, and writes them: the input row
//   is written once. R and J adapt to the shape (C, the dtype, the card's
//   SM count). Neighbouring row groups stream in opposite directions, so
//   the f rows of dy that two of them read are read at about the same
//   time, the second time from L2.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxF = 32;      // largest factor (taps live in a static table)
constexpr int kGroups = 4;     // forward: q (f output rows each) a block writes
constexpr int kWords = 2;      // backward: 16-byte slots of a dy row segment per thread
constexpr int kAhead = 4;      // backward: dy rows loaded ahead, per thread
// backward: the bytes of a dy row segment a block reads (the rest of its
// kThreads * kWords slots is room for the segment's offset modulo 16)
constexpr int kSegmentBytes = kThreads * kWords * 16 - 16;
constexpr int kSmemMax = 227 * 1024;     // a block's shared memory on Hopper
constexpr int kSmemDefault = 48 * 1024;  // above it a kernel must opt in
constexpr int kStaticSmem = 1024;        // a kernel's static shared memory, at most

template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

template <typename T>
__device__ __forceinline__ T narrow(typename AccOf<T>::type v);
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ double narrow<double>(double v) { return v; }

// The 2f one-dimensional taps, in double as bilinear_kernel computes them,
// into tap[0, 2f); the caller syncs.
template <typename A>
__device__ __forceinline__ void fill_taps(A* tap, int f) {
  const int t = threadIdx.x;
  if (t < 2 * f) {
    const double c = static_cast<double>(2 * f - 1 - f % 2) / (2.0 * f);
    const double d = static_cast<double>(t) / f - c;
    tap[t] = static_cast<A>(1.0 - (d < 0 ? -d : d));
  }
}

// kVec values of T as one 16-byte word, from registers (no local array
// whose address is taken).
__device__ __forceinline__ uint32_t pair_bits(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}
__device__ __forceinline__ uint32_t pair_bits(__half lo, __half hi) {
  return static_cast<uint32_t>(__half_as_ushort(lo)) |
         (static_cast<uint32_t>(__half_as_ushort(hi)) << 16);
}
template <typename T>
__device__ __forceinline__ uint4 pack(const T (&v)[8]) {
  return make_uint4(pair_bits(v[0], v[1]), pair_bits(v[2], v[3]), pair_bits(v[4], v[5]),
                    pair_bits(v[6], v[7]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const double (&v)[2]) {
  return make_uint4(static_cast<uint32_t>(__double2loint(v[0])),
                    static_cast<uint32_t>(__double2hiint(v[0])),
                    static_cast<uint32_t>(__double2loint(v[1])),
                    static_cast<uint32_t>(__double2hiint(v[1])));
}

// kF is the factor where it is known at compile time (8), else 0 and the
// factor is f_rt. A block writes the rows of kGroups consecutive q, from
// q_lo + kGroups * (its group chunk) on.
template <typename T, int kF>
__global__ void __launch_bounds__(kThreads, 4)
upsample_forward_kernel(const T* __restrict__ x, T* __restrict__ y, int Hi, int Wi, int C,
                        int f_rt, int ph, int pw, int Ho, int Wo, int q_lo, int q_end,
                        int n_chunks, int n_tiles) {
  using A = typename AccOf<T>::type;
  constexpr int kVec = 16 / sizeof(T);
  const int f = kF ? kF : f_rt;
  __shared__ A tap[2 * kMaxF];
  fill_taps(tap, f);
  __syncthreads();

  const int tile = blockIdx.x % n_tiles;
  const int rest = blockIdx.x / n_tiles;
  const int qa = q_lo + (rest % n_chunks) * kGroups;
  const int qb = min(q_end, qa + kGroups);
  const int n = rest / n_chunks;
  const int64_t len = static_cast<int64_t>(Wo) * C;  // elements of an output row
  const int64_t e0 = (static_cast<int64_t>(tile) * kThreads + threadIdx.x) * kVec;
  if (e0 >= len) return;
  const int ne = static_cast<int>(len - e0 < kVec ? len - e0 : kVec);

  // each element's input column s, as its offset s C + c in a row of x
  // (-1 past the row's end), with the tap w(sr); column s - 1 takes
  // w(sr + f). A column outside the input adds zero.
  int sc[kVec], sr_of[kVec];
  {
    int ow = static_cast<int>(e0 / C);
    int c = static_cast<int>(e0 - static_cast<int64_t>(ow) * C);
    int s = (ow + pw) / f;
    int sr = ow + pw - s * f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      sc[e] = e < ne ? s * C + c : -1;
      sr_of[e] = sr;
      if (++c == C) {
        c = 0;
        if (++sr == f) {
          sr = 0;
          ++s;
        }
      }
    }
  }
  // the horizontal blend of input row r at this word's elements; zero for a
  // row outside the input
  const int in_row = Wi * C;
  auto blend = [&](int r, A (&h)[kVec]) {
    const bool inside = r >= 0 && r < Hi;
    const T* xr = x + (static_cast<int64_t>(n) * Hi + (inside ? r : 0)) * in_row;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      A v = 0;
      if (inside && sc[e] >= 0 && sc[e] < in_row) v = tap[sr_of[e]] * widen(xr[sc[e]]);
      if (inside && sc[e] >= C && sc[e] - C < in_row)
        v += tap[sr_of[e] + f] * widen(xr[sc[e] - C]);
      h[e] = v;
    }
  };

  A lo[kVec], hi[kVec];  // blends of rows q - 1 and q
  blend(qa - 1, lo);
  for (int q = qa; q < qb; ++q) {
    blend(q, hi);
    const int o_lo = max(0, q * f - ph);
    const int o_hi = min(Ho, q * f - ph + f);
    T* out = y + (static_cast<int64_t>(n) * Ho + o_lo) * len + e0;
    for (int o = o_lo; o < o_hi; ++o, out += len) {
      const int r = o + ph - q * f;
      const A v0 = tap[r], v1 = tap[r + f];
      T vals[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = narrow<T>(v0 * hi[e] + v1 * lo[e]);
      if (ne == kVec && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        __stcs(reinterpret_cast<uint4*>(out), pack(vals));  // streamed: y is not read back
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (e < ne) out[e] = vals[e];
      }
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) lo[e] = hi[e];
  }
}

// 16-byte words of device memory as kVec accumulator values.
__device__ __forceinline__ void unpack(const uint4& w, float (&v)[8], __nv_bfloat16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& w, float (&v)[8], __half) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __half2float(__ushort_as_half(static_cast<unsigned short>(u[i] & 0xffffu)));
    v[2 * i + 1] = __half2float(__ushort_as_half(static_cast<unsigned short>(u[i] >> 16)));
  }
}
__device__ __forceinline__ void unpack(const uint4& w, float (&v)[4], float) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, double (&v)[2], double) {
  v[0] = __hiloint2double(static_cast<int>(w.y), static_cast<int>(w.x));
  v[1] = __hiloint2double(static_cast<int>(w.w), static_cast<int>(w.z));
}

// kN accumulator values to shared memory as 16-byte stores.
template <int kN>
__device__ __forceinline__ void store_words(float* to, const float (&v)[kN]) {
#pragma unroll
  for (int e = 0; e < kN / 4; ++e)
    reinterpret_cast<float4*>(to)[e] = make_float4(v[4 * e], v[4 * e + 1], v[4 * e + 2],
                                                   v[4 * e + 3]);
}
template <int kN>
__device__ __forceinline__ void store_words(double* to, const double (&v)[kN]) {
#pragma unroll
  for (int e = 0; e < kN / 2; ++e)
    reinterpret_cast<double2*>(to)[e] = make_double2(v[2 * e], v[2 * e + 1]);
}

// The bytes of the dy row segment that a backward block of j input columns
// reads: (j + j % 2 + 1) f C elements, the windows of its column pairs.
template <typename T>
__host__ __device__ constexpr int segment_bytes(int j, int f, int c) {
  return (j + (j & 1) + 1) * f * c * static_cast<int>(sizeof(T));
}

// A block takes input rows [i0, i1) and columns [j0, j0 + nj), all C
// channels, and streams down the dy rows that feed them. Each thread owns
// kWords slots of kVec consecutive elements of the block's row segment, the
// same in every row: a 16-byte word of dy where rows start 16-byte aligned
// (one load, kAhead rows ahead in registers), else element loads. It adds
// each row's slots, times the row's two taps, into float registers that
// hold the vertical sums of the two input rows the row feeds. When the rows
// move past an input row, its sums go to shared memory, 16-byte stores at
// the slots' places, and each thread reduces them along W for its pair of
// columns (2p, 2p + 1) of one channel, p = threadIdx.x / C, whose 2f-tap
// windows share f columns. Odd row groups stream their rows bottom up, so
// the f rows a group shares with each neighbour are read by both at about
// the same time, the second time from L2.
template <typename T, int kF>
__global__ void __launch_bounds__(kThreads, 2)
upsample_backward_kernel(const T* __restrict__ dy, T* __restrict__ dx, int Hi, int Wi, int C,
                         int f_rt, int ph, int pw, int Ho, int Wo, int R, int J, int n_rgroups,
                         int n_ctiles, int pad) {
  using A = typename AccOf<T>::type;
  constexpr int kVec = 16 / sizeof(T);
  const int f = kF ? kF : f_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ A tap[2 * kMaxF];
  fill_taps(tap, f);

  const int ct = blockIdx.x % n_ctiles;
  const int rest = blockIdx.x / n_ctiles;
  const int rg = rest % n_rgroups;
  const bool up = rg & 1;  // rows bottom up
  const int i0 = rg * R;
  const int n = rest / n_rgroups;
  const int i1 = min(Hi, i0 + R);  // input rows [i0, i1)
  const int j0 = ct * J;
  const int nj = min(J, Wi - j0);  // input columns [j0, j0 + nj)
  // the windows of the pairs start at dy column cl; the row segment read is
  // [vlo, vhi) (columns outside [0, Wo) add zero)
  const int cl = j0 * f - pw;
  const int vlo = max(cl, 0) * C;
  const int vhi = min(cl + (nj + 1) * f, Wo) * C;
  const int o_lo = max(0, i0 * f - ph);  // dy rows [o_lo, o_hi)
  const int o_hi = min(Ho, (i1 + 1) * f - ph);
  const int n_rows = o_hi - o_lo;
  const int64_t out_row = static_cast<int64_t>(Wo) * C;
  const T* dy_n = dy + static_cast<int64_t>(n) * Ho * out_row;
  // slot s holds the row's elements first + s kVec + e, e < kVec
  const bool aligned = ((reinterpret_cast<uintptr_t>(dy) | (out_row * sizeof(T))) & 15) == 0;
  const int first = aligned ? vlo / kVec * kVec : cl * C;
  // the vertical sums of a completed input row: the slots' elements at
  // pad + s kVec + e, column cl's first at pad + cl C - first; [0, pad) is
  // zero (columns before 0)
  A* vsum = reinterpret_cast<A*>(smem);
  for (int i = threadIdx.x; i < pad; i += kThreads) vsum[i] = 0;

  auto row_of = [&](int k) { return up ? o_hi - 1 - k : o_lo + k; };
  auto load = [&](int k, uint4 (&dst)[kWords]) {
    const T* row = dy_n + static_cast<int64_t>(row_of(k)) * out_row;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int at = first + static_cast<int>(threadIdx.x + w * kThreads) * kVec;
      if (aligned) {
        dst[w] = at + kVec > vlo && at < vhi ? __ldg(reinterpret_cast<const uint4*>(row + at))
                                             : make_uint4(0, 0, 0, 0);
      } else {
        T v[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          v[e] = at + e >= vlo && at + e < vhi ? row[at + e] : narrow<T>(0);
        dst[w] = pack(v);
      }
    }
  };

  // vertical sums of input rows cq (cur) and cq - 1 (prev) at the slots
  A cur[kWords][kVec], prev[kWords][kVec];
#pragma unroll
  for (int w = 0; w < kWords; ++w)
#pragma unroll
    for (int e = 0; e < kVec; ++e) cur[w][e] = prev[w][e] = 0;
  int cq = up ? i1 : i0;
  const int p = threadIdx.x / C;
  const int c = threadIdx.x - p * C;
  const int ja = 2 * p;  // the pair's columns, within the block
  const bool has_a = ja < nj, has_b = ja + 1 < nj;
  T* dx_pair = dx + (static_cast<int64_t>(n) * Hi * Wi + j0 + ja) * C + c;
  const A* window = vsum + pad + cl * C - first + ja * f * C + c;
  // input row i is complete: reduce its vertical sums along W and write it
  auto emit = [&](int i, const A (&v)[kWords][kVec]) {
    if (i < i0 || i >= i1) return;  // uniform over the block
#pragma unroll
    for (int w = 0; w < kWords; ++w)  // 16-byte stores, neighbouring threads adjacent
      store_words(vsum + pad + (threadIdx.x + w * kThreads) * kVec, v[w]);
    __syncthreads();
    if (has_a) {
      // the pair's windows: columns [0, 2f) for a, [f, 3f) for b
      A ha = 0, hb = 0;
#pragma unroll 4
      for (int u = 0; u < f; ++u) ha += tap[u] * window[u * C];
#pragma unroll 4
      for (int u = f; u < 2 * f; ++u) {
        const A x = window[u * C];
        ha += tap[u] * x;
        hb += tap[u - f] * x;
      }
#pragma unroll 4
      for (int u = 2 * f; u < 3 * f; ++u) hb += tap[u - f] * window[u * C];
      T* out = dx_pair + static_cast<int64_t>(i) * Wi * C;
      out[0] = narrow<T>(ha);
      if (has_b) out[C] = narrow<T>(hb);
    }
    __syncthreads();  // before vsum is written again
  };
  // the rows move past input row cq - 1 (top down) or cq (bottom up)
  auto advance = [&]() {
    if (up)
      emit(cq, cur);
    else
      emit(cq - 1, prev);
#pragma unroll
    for (int w = 0; w < kWords; ++w)
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        if (up) {
          cur[w][e] = prev[w][e];
          prev[w][e] = 0;
        } else {
          prev[w][e] = cur[w][e];
          cur[w][e] = 0;
        }
      }
    cq += up ? -1 : 1;
  };

  uint4 ring[kAhead][kWords];  // rows k .. k + kAhead - 1, loaded ahead
#pragma unroll
  for (int d = 0; d < kAhead; ++d)
    if (d < n_rows) load(d, ring[d]);
  __syncthreads();  // the taps and vsum's zeros
  for (int k0 = 0; k0 < n_rows; k0 += kAhead) {
#pragma unroll
    for (int d = 0; d < kAhead; ++d) {
      const int k = k0 + d;
      if (k >= n_rows) break;
      const int o = row_of(k);
      const int q = (o + ph) / f;
      const int r = o + ph - q * f;
      while (up ? cq > q : cq < q) advance();
      const A wq = tap[r], wp = tap[r + f];
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        A v[kVec];
        unpack(ring[d][w], v, T());
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          cur[w][e] += wq * v[e];
          prev[w][e] += wp * v[e];
        }
      }
      if (k + kAhead < n_rows) load(k + kAhead, ring[d]);
    }
  }
  while (up ? cq >= i0 : cq <= i1) advance();
}

int dtype_size(int dtype) {
  switch (dtype) {
    case 0: return 2;  // bf16
    case 1: return 2;  // fp16
    case 2: return 4;  // float
    case 3: return 8;  // double
    default: return 0;
  }
}

bool bad_shape(int N, int Hi, int Wi, int C, int f, int ph, int pw) {
  return N <= 0 || Hi <= 0 || Wi <= 0 || C <= 0 || f < 1 || f > kMaxF || ph < 0 || pw < 0 ||
         (Hi + 1) * f - 2 * ph <= 0 || (Wi + 1) * f - 2 * pw <= 0;
}

template <typename T, int kF>
int launch_forward(const void* x, void* y, int N, int Hi, int Wi, int C, int f, int ph, int pw,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int Ho = (Hi + 1) * f - 2 * ph, Wo = (Wi + 1) * f - 2 * pw;
  const int64_t len = static_cast<int64_t>(Wo) * C;
  const int64_t n_tiles = (len + kThreads * kVec - 1) / (kThreads * kVec);
  const int q_lo = ph / f, q_end = (Ho - 1 + ph) / f + 1;  // the q of output rows 0, Ho - 1
  const int64_t n_chunks = (q_end - q_lo + kGroups - 1) / kGroups;
  const int64_t blocks = N * n_chunks * n_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  upsample_forward_kernel<T, kF><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), Hi, Wi, C, f, ph, pw, Ho, Wo, q_lo, q_end,
      static_cast<int>(n_chunks), static_cast<int>(n_tiles));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kF>
int launch_backward(const void* dy, void* dx, int N, int Hi, int Wi, int C, int f, int ph,
                    int pw, cudaStream_t stream) {
  // a thread per channel in the reduction along W, and one input column's
  // segment (three with the pairs' rounding) in a block's slots
  if (C > kThreads || segment_bytes<T>(1, f, C) > kSegmentBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = (Hi + 1) * f - 2 * ph, Wo = (Wi + 1) * f - 2 * pw;
  // J input columns a block: two for each group of C threads, as many as
  // the slots hold
  int J = 2 * (kThreads / C);
  if (J > Wi) J = Wi;
  while (J > 1 && segment_bytes<T>(J, f, C) > kSegmentBytes) --J;
  // the vertical sums: the slots' elements after pad zeros (columns before 0)
  constexpr int kVec = 16 / sizeof(T);
  const int pad = (pw * C + kVec - 1) / kVec * kVec;
  const int smem = (pad + kThreads * kWords * kVec) *
                   static_cast<int>(sizeof(typename AccOf<T>::type));
  if (smem + kStaticSmem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = upsample_backward_kernel<T, kF>;
  if (smem + kStaticSmem > kSmemDefault) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_ctiles = (Wi + J - 1) / J;
  // R input rows a block: enough blocks for ~8 on each SM, at most 8 rows
  // (each block reads f rows of dy that a neighbour reads too)
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int64_t R = static_cast<int64_t>(N) * n_ctiles * Hi / (8 * static_cast<int64_t>(sms));
  R = R < 1 ? 1 : (R > 8 ? 8 : R);
  if (R > Hi) R = Hi;
  const int n_rgroups = static_cast<int>((Hi + R - 1) / R);
  const int64_t blocks = static_cast<int64_t>(N) * n_rgroups * n_ctiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(dy), static_cast<T*>(dx), Hi, Wi, C, f, ph, pw, Ho, Wo,
      static_cast<int>(R), J, n_rgroups, n_ctiles, pad);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(bool backward, const void* src, void* dst, int N, int Hi, int Wi, int C, int f,
             int ph, int pw, cudaStream_t s) {
  // the heads' factor 8 unrolled; any other (FCN8s's 2x too) at run time
  if (backward)
    return f == 8 ? launch_backward<T, 8>(src, dst, N, Hi, Wi, C, f, ph, pw, s)
                  : launch_backward<T, 0>(src, dst, N, Hi, Wi, C, f, ph, pw, s);
  return f == 8 ? launch_forward<T, 8>(src, dst, N, Hi, Wi, C, f, ph, pw, s)
                : launch_forward<T, 0>(src, dst, N, Hi, Wi, C, f, ph, pw, s);
}

int run(bool backward, const void* src, void* dst, int dtype, int N, int Hi, int Wi, int C,
        int f, int ph, int pw, void* stream) {
  if (dtype_size(dtype) == 0 || bad_shape(N, Hi, Wi, C, f, ph, pw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<__nv_bfloat16>(backward, src, dst, N, Hi, Wi, C, f, ph, pw, s);
    case 1: return dispatch<__half>(backward, src, dst, N, Hi, Wi, C, f, ph, pw, s);
    case 2: return dispatch<float>(backward, src, dst, N, Hi, Wi, C, f, ph, pw, s);
    default: return dispatch<double>(backward, src, dst, N, Hi, Wi, C, f, ph, pw, s);
  }
}

}  // namespace

// C entry points for ctypes. dtype: 0 bf16, 1 fp16, 2 float, 3 double.
// [N, Hi, Wi, C] is the input's shape as the kernel sees it (see Layout
// above); the output's is [N, (Hi + 1) f - 2 ph, (Wi + 1) f - 2 pw, C].
// Forward: x -> y. Backward: dy (the output's shape) -> dx (the input's).
// Both contiguous, at any element-aligned address; C <= 256 for the
// backward. Return cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a shape they do not take.
extern "C" int mcseg_upsample_convt_forward(const void* x, void* y, int dtype, int N, int Hi,
                                            int Wi, int C, int f, int ph, int pw,
                                            void* stream) {
  return run(false, x, y, dtype, N, Hi, Wi, C, f, ph, pw, stream);
}

extern "C" int mcseg_upsample_convt_backward(const void* dy, void* dx, int dtype, int N,
                                             int Hi, int Wi, int C, int f, int ph, int pw,
                                             void* stream) {
  return run(true, dy, dx, dtype, N, Hi, Wi, C, f, ph, pw, stream);
}
