// fir_up2d: the adjoint of fir_down2d (its backward): the gradient dx of
// the forward's input from the gradient g of its output, a 4-tap separable
// FIR transposed with 2x upsampling on both spatial axes, in one pass, on
// a logical NCHW tensor (contiguous NCHW or channels_last).
//
// No TPU kernel of its own: the JAX package differentiates ditsep_tpu/ops/
// fir.py:downsample_2d (the function ditsep_tpu/ops/pallas_kernels.py:
// fir_down2_h_pallas computes) with XLA. The forward weighs input sample
// 2i-1+a by the flipped tap t[a] for output i (pad 1 each side), so along
// one axis
//   dx[2r]   = t[1]*g[r]   + t[3]*g[r-1]
//   dx[2r+1] = t[0]*g[r+1] + t[2]*g[r]
// with g = 0 outside its H//2 (W//2) samples; dx has the forward input's
// size, odd sizes included. Both axes: the W pass over each of the three g
// rows a quad reads, then the H pass; H taps t = k/sum(k), W taps
// t = k/sum(k)*gain, as fir_down2d.
//
// Bound on an H100: memory. 8 operations an output against 5/4 elements
// moved (dx written once, g read once), so the least time is
//   bytes = (N*C*H*W + N*C*floor(H/2)*floor(W/2)) * sizeof(dtype)
// over the card's memory bandwidth; dx is 4/5 of the bytes, so the stores
// decide: 16-byte stores wherever the layout and alignment allow.
//
// Design: one thread an output quad of 2 rows x 2V columns (NCHW) or of
// 2 x 2 pixels x V channels (channels_last), reading the 3 x (V+2) (3 x 3
// pixel) window of g it needs; the window's rows and columns are shared
// with the neighbouring threads through L1. The launch plan (ops/
// cuda_kernels.py:fir_up2d_plan) picks the path, the block and the grid;
// this file checks that they fit the tensor and launches nothing otherwise.
// 32-bit indices from the grid, 64-bit plane or image bases; gridDim.y
// walks planes (NCHW) or images (channels_last), looping past 65,535.
// * NCHW, vector path (W a multiple of 2V, 16-byte aligned; V = 2 f32,
//   4 bf16): the V centre values of each g row come in one 8-byte load,
//   the one on each side as an element; each output row is one 16-byte
//   store. Scalar path (any W, any alignment): V = 1, element loads and
//   stores, the odd last column and row masked.
// * channels_last, vector path (C a multiple of V, 16-byte aligned; V = 4
//   f32, 8 bf16): nine 16-byte loads, four 16-byte stores; scalar path
//   V = 1.
// Every path computes an output as the plain version does (ops/
// cuda_kernels.py:downsample_2d_bwd_plain): W pass, then H pass, each
// a*b + c*d in f32 with no fused multiply-add, a zero where g is outside,
// one rounding to the output type. So the paths give the same bits, and
// the same bits as the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxGridY = 65535;

struct Taps {
  float h[4];  // flipped H taps, as fir_down2d takes them
  float w[4];  // flipped W taps (gain folded in)
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// a*b + c*d, in the plain version's order, never contracted to FMAs
__device__ __forceinline__ float dot2(float a, float b, float c, float d) {
  return __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

// element e of a vector of 32-bit words (f32, or bf16 pairs: element 2k
// in the low half of word k), as f32
template <typename T>
__device__ __forceinline__ float elem(const uint32_t* w, int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else {
    const uint32_t v = w[e >> 1];
    return __uint_as_float((e & 1) ? (v & 0xffff0000u) : (v << 16));
  }
}

// N f32 values rounded to T and packed into N * sizeof(T) / 4 words
template <typename T, int N>
__device__ __forceinline__ void pack(const float (&o)[N], uint32_t* w) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int k = 0; k < N; ++k) w[k] = __float_as_uint(o[k]);
  } else {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(o[2 * k], o[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&p);
    }
  }
}

// NCHW. Block: blockDim.x groups of V g columns (2V output columns) x
// blockDim.y row pairs, of one plane; blockIdx.x = column tile x
// row_tiles + row tile, blockIdx.y the first plane.
template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
fir_up2d_nchw(const T* __restrict__ g, T* __restrict__ dx, int planes,
              int h, int w, int ho, int wo, int groups, int pairs,
              int row_tiles, Taps taps) {
  const int gi = (blockIdx.x / row_tiles) * blockDim.x + threadIdx.x;
  const int r = (blockIdx.x % row_tiles) * blockDim.y + threadIdx.y;
  if (gi >= groups || r >= pairs) return;
  const int c0 = V * gi;  // the first g column of the quad
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const T* gp = g + (size_t)p * ho * wo;
    T* dp = dx + (size_t)p * h * w;
    // s[k][1 + v]: g row r - 1 + k, column c0 + v, as f32 (0 outside)
    float s[3][V + 2];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int row = r - 1 + k;
      const bool row_ok = row >= 0 && row < ho;
      const T* rp = gp + (size_t)(row_ok ? row : 0) * wo + c0;
      if constexpr (VEC) {  // c0 + V <= wo: the centre lies inside
        uint2 q = make_uint2(0, 0);
        if (row_ok) q = __ldg(reinterpret_cast<const uint2*>(rp));
        const uint32_t words[2] = {q.x, q.y};
#pragma unroll
        for (int v = 0; v < V; ++v) s[k][1 + v] = elem<T>(words, v);
      } else {
        s[k][1] = row_ok && c0 < wo ? to_f32(rp[0]) : 0.f;
      }
      s[k][0] = row_ok && c0 > 0 ? to_f32(rp[-1]) : 0.f;
      s[k][V + 1] = row_ok && c0 + V < wo ? to_f32(rp[V]) : 0.f;
    }
    // W pass: u[k][e] for output columns 2*c0 + e of g row r - 1 + k
    float u[3][2 * V];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        u[k][2 * v] = dot2(taps.w[1], s[k][1 + v], taps.w[3], s[k][v]);
        u[k][2 * v + 1] =
            dot2(taps.w[0], s[k][2 + v], taps.w[2], s[k][1 + v]);
      }
    }
    // H pass: output rows 2r and 2r + 1
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int row = 2 * r + a;
      if (row >= h) break;
      float o[2 * V];
#pragma unroll
      for (int e = 0; e < 2 * V; ++e)
        o[e] = a == 0 ? dot2(taps.h[1], u[1][e], taps.h[3], u[0][e])
                      : dot2(taps.h[0], u[2][e], taps.h[2], u[1][e]);
      T* op = dp + (size_t)row * w + 2 * c0;
      if constexpr (VEC) {
        uint32_t words[4];
        pack<T, 2 * V>(o, words);
        *reinterpret_cast<uint4*>(op) =
            make_uint4(words[0], words[1], words[2], words[3]);
      } else {
        op[0] = from_f32<T>(o[0]);
        if (2 * c0 + 1 < w) op[1] = from_f32<T>(o[1]);
      }
    }
  }
}

// channels_last. Block: blockDim.x vectors of V channels x blockDim.y quad
// columns, of one quad row of one image; blockIdx.x = (pair x col_tiles +
// column tile) x chan_tiles + channel tile, blockIdx.y the first image.
template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
fir_up2d_nhwc(const T* __restrict__ g, T* __restrict__ dx, int images,
              int c, int h, int w, int ho, int wo, int groups,
              int chan_tiles, int col_tiles, Taps taps) {
  const int b = blockIdx.x / chan_tiles;
  const int gi = (blockIdx.x % chan_tiles) * blockDim.x + threadIdx.x;
  const int j = (b % col_tiles) * blockDim.y + threadIdx.y;
  const int r = b / col_tiles;
  if (gi >= groups || 2 * j >= w) return;
  for (int n = blockIdx.y; n < images; n += gridDim.y) {
    const T* gp = g + (size_t)n * ho * wo * c + V * gi;
    T* dp = dx + (size_t)n * h * w * c + V * gi;
    // s[k][m][e]: g pixel (r - 1 + k, j - 1 + m), channel V*gi + e
    float s[3][3][V];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int row = r - 1 + k, col = j - 1 + m;
        const bool ok = row >= 0 && row < ho && col >= 0 && col < wo;
        const T* pp = gp + ((size_t)(ok ? row : 0) * wo + (ok ? col : 0)) * c;
        if constexpr (VEC) {
          uint4 q = make_uint4(0, 0, 0, 0);
          if (ok) q = __ldg(reinterpret_cast<const uint4*>(pp));
          const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int e = 0; e < V; ++e) s[k][m][e] = elem<T>(words, e);
        } else {
          s[k][m][0] = ok ? to_f32(*pp) : 0.f;
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int row = 2 * r + a;
      if (row >= h) break;
#pragma unroll
      for (int bb = 0; bb < 2; ++bb) {
        const int col = 2 * j + bb;
        if (col >= w) break;
        float o[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          // W pass of the g rows this output row reads, then the H pass
          float u[3];
#pragma unroll
          for (int k = 0; k < 3; ++k)
            u[k] = bb == 0 ? dot2(taps.w[1], s[k][1][e], taps.w[3], s[k][0][e])
                           : dot2(taps.w[0], s[k][2][e], taps.w[2],
                                  s[k][1][e]);
          o[e] = a == 0 ? dot2(taps.h[1], u[1], taps.h[3], u[0])
                        : dot2(taps.h[0], u[2], taps.h[2], u[1]);
        }
        T* op = dp + ((size_t)row * w + col) * c;
        if constexpr (VEC) {
          uint32_t words[4];
          pack<T, V>(o, words);
          *reinterpret_cast<uint4*>(op) =
              make_uint4(words[0], words[1], words[2], words[3]);
        } else {
          op[0] = from_f32<T>(o[0]);
        }
      }
    }
  }
}

int ceil_div(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool VEC>
int launch(const void* g, void* dx, int channels_last, int n, int c, int h,
           int w, int bx, int by, int64_t gx, int gy, const Taps& taps,
           cudaStream_t stream) {
  const int ho = h / 2, wo = w / 2, pairs = (h + 1) / 2;
  const dim3 grid((unsigned)gx, (unsigned)gy), block(bx, by);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  if (VEC && (!aligned(g) || !aligned(dx))) return cudaErrorInvalidValue;
  if (!channels_last) {
    constexpr int V = VEC ? 8 / (int)sizeof(T) : 1;
    if (VEC && w % (2 * V)) return cudaErrorInvalidValue;
    const int groups = ceil_div(w, 2 * V);
    const int row_tiles = ceil_div(pairs, by);
    if (gx != (int64_t)row_tiles * ceil_div(groups, bx))
      return cudaErrorInvalidValue;
    fir_up2d_nchw<T, V, VEC><<<grid, block, 0, stream>>>(
        gt, dt, n * c, h, w, ho, wo, groups, pairs, row_tiles, taps);
  } else {
    constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;
    if (VEC && c % V) return cudaErrorInvalidValue;
    const int groups = c / V;
    const int chan_tiles = ceil_div(groups, bx);
    const int col_tiles = ceil_div((w + 1) / 2, by);
    if (gx != (int64_t)chan_tiles * col_tiles * pairs)
      return cudaErrorInvalidValue;
    fir_up2d_nhwc<T, V, VEC><<<grid, block, 0, stream>>>(
        gt, dt, n, c, h, w, ho, wo, groups, chan_tiles, col_tiles, taps);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_path(int vector, const void* g, void* dx, int channels_last,
                int n, int c, int h, int w, int bx, int by, int64_t gx,
                int gy, const Taps& taps, cudaStream_t s) {
  return vector ? launch<T, true>(g, dx, channels_last, n, c, h, w, bx, by,
                                  gx, gy, taps, s)
                : launch<T, false>(g, dx, channels_last, n, c, h, w, bx, by,
                                   gx, gy, taps, s);
}

}  // namespace

// One launch of the plan made by ops/cuda_kernels.py:fir_up2d_plan.
// g: (n, c, h/2, w/2), dx: (n, c, h, w), both in one layout; dtype: 0 =
// float32, 1 = bfloat16; channels_last: 0 = contiguous NCHW, 1 =
// channels_last strides; vector: 1 = 16-byte path, 0 = element path;
// block (bx, by), grid (gx, gy). taps points to 8 host floats (4 H taps,
// then 4 W taps, both flipped, as fir_down2d takes them).
// Returns cudaErrorInvalidValue (1), launching nothing, when the plan does
// not fit the tensors (grid, block, alignment, W or C for the vector path,
// sizes past 32 bits); else cudaGetLastError() after the launch.
extern "C" int fir_up2d(const void* g, void* dx, int dtype, int channels_last,
                        int vector, int64_t n, int64_t c, int64_t h,
                        int64_t w, int bx, int by, int64_t gx, int gy,
                        const float* taps, void* stream) {
  const int64_t kInt = 0x7fffffff;
  if (n < 1 || c < 1 || h < 2 || w < 2 || n * c > kInt || h > kInt
      || w > kInt || bx < 1 || by < 1 || bx * by > kMaxThreads || gx < 1
      || gx > kInt || gy < 1 || gy > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps t;
  for (int k = 0; k < 4; ++k) {
    t.h[k] = taps[k];
    t.w[k] = taps[4 + k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_path<float>(vector, g, dx, channels_last, (int)n, (int)c,
                              (int)h, (int)w, bx, by, gx, gy, t, s);
  if (dtype == 1)
    return launch_path<__nv_bfloat16>(vector, g, dx, channels_last, (int)n,
                                      (int)c, (int)h, (int)w, bx, by, gx, gy,
                                      t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
