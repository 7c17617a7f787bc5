// fir_down2d: 4-tap separable FIR with 2x decimation on both spatial axes,
// in one pass, on a logical NCHW tensor (contiguous NCHW or channels_last).
//
// Replaces ditsep_tpu/ops/pallas_kernels.py:fir_down2_h_pallas and its
// wrapper downsample_2d_pallas, i.e. ditsep_tpu/ops/fir.py:downsample_2d(
// x, k, 2, gain) for a 4-tap k: pad (1, 1), taps flipped (a true
// convolution), H taps k/sum(k), W taps k/sum(k)*gain, output
// floor(H/2) x floor(W/2). Reads outside the input are zero (the pad).
//
// Bound on an H100: memory. 32 flops an output against at least 5/4 x 4
// input-and-output elements, so the least time is
//   bytes = (N*C*H*W + N*C*floor(H/2)*floor(W/2)) * sizeof(dtype)
// over the card's memory bandwidth. What matters is bytes in flight,
// instructions per byte and reading each input row from DRAM once.
//
// Design. The launch plan (ops/cuda_kernels.py:fir_down2d_plan) picks the
// path, the block and the grid; this file checks that they fit the tensor
// and launches nothing otherwise. All indices are
// 32-bit and come from the grid: a block's coordinates from blockIdx (one
// division a thread), addresses from a 64-bit plane or image base plus
// widening 32 x 32-bit products; no per-element div/mod. gridDim.y walks
// planes (NCHW) or images (channels_last), looping past 65,535.
// * NCHW (the main path): threadIdx.x runs along W in groups of V outputs,
//   threadIdx.y down the plane, R = 2 output rows a thread. On the vector
//   path (W a multiple of 2V, 16-byte aligned; V = 4 f32, 8 bf16) a thread
//   loads its 2V input columns of each of its 2R+2 input rows as two
//   16-byte vectors, all before any arithmetic, and stores one 16-byte
//   vector an output row. The one column it needs on each side is the
//   H-filtered last / first column of the lanes beside it (__shfl_up/
//   down_sync); only a lane at a warp or tile edge loads that column
//   itself. The two rows a thread shares with the thread below come from
//   L1, not DRAM. The scalar path (any W, any alignment) is the same code
//   with V = 1 and element loads.
// * channels_last: threadIdx.x runs along C in vectors of V channels (the
//   vector path needs C a multiple of V and 16-byte alignment; else V = 1),
//   threadIdx.y along output columns. A thread walks R = 5 output rows
//   down the image, loading two input rows (4 pixels each) a step and
//   carrying the first half of each column's H sum to the next step, so
//   it reads each input row once: with all 2R+2 rows in registers at once
//   the register count halved the blocks an SM holds.
// Every path computes an output as the plain version does
// (downsample_2d_plain): the H pass over each column, then the W pass,
// each ((t0*a + t1*b) + t2*c) + t3*d in f32 without fused multiply-adds,
// a column outside the input is 0, and one rounding to the output type.
// So the paths give the same bits, and in the chip runs the same bits as
// the plain version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxGridY = 65535;
// output rows a thread, by layout (ops/cuda_kernels.py:FIR_ROWS): the
// fastest at the flagship's level-0 shapes on an H100, of 1, 2 and 4
// (NCHW) and of 1 to 6 and 8 (channels_last)
constexpr int kRowsNchw = 2;
constexpr int kRowsNhwc = 5;

struct Taps {
  float h[4];  // flipped H taps: row 2i-1+a is weighted by h[a]
  float w[4];  // flipped W taps (gain folded in): col 2j-1+b by w[b]
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

// the plain version's 4-tap sum, in its order, never contracted to FMAs
__device__ __forceinline__ float tap4(const float (&t)[4], float a, float b,
                                      float c, float d) {
  float s = __fmul_rn(t[0], a);
  s = __fadd_rn(s, __fmul_rn(t[1], b));
  s = __fadd_rn(s, __fmul_rn(t[2], c));
  return __fadd_rn(s, __fmul_rn(t[3], d));
}

// a 16-byte vector of T: word i, element e (compile-time constants after
// unrolling) as f32, and V = 16 / sizeof(T) f32 values rounded into one
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int e) {
  const uint32_t w = word(v, e * (int)sizeof(T) / 4);
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w);
  } else {  // bf16: the high half of an f32 (element 2k in the low half)
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

template <typename T, int V>
__device__ __forceinline__ uint4 pack(const float (&o)[V]) {
  static_assert(V * sizeof(T) == 16, "one 16-byte vector");
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if constexpr (sizeof(T) == 4) {
      w[k] = __float_as_uint(o[k]);
    } else {
      const __nv_bfloat162 p = __floats2bfloat162_rn(o[2 * k], o[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&p);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// NCHW. Block: blockDim.x groups of V output columns x blockDim.y thread
// rows of R output rows, of one plane; blockIdx.x = column tile x
// row_tiles + row tile, blockIdx.y the first plane.
template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
fir_down2d_nchw(const T* __restrict__ x, T* __restrict__ y, int planes,
                int h, int w, int ho, int wo, int groups, int row_tiles,
                Taps taps) {
  constexpr int R = kRowsNchw;
  constexpr int NI = 2 * V;      // input columns a thread owns
  constexpr int NR = 2 * R + 2;  // input rows its output rows read
  constexpr int NQ = NI * sizeof(T) / 16;  // its 16-byte vectors a row
  constexpr int EQ = 16 / sizeof(T);       // elements a 16-byte vector
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31;
  const int in_warp = min(32, (int)(blockDim.x * blockDim.y) - (tid & ~31));
  const unsigned mask = in_warp == 32 ? 0xffffffffu : (1u << in_warp) - 1u;
  const int g = (blockIdx.x / row_tiles) * blockDim.x + threadIdx.x;
  const int i0 = ((blockIdx.x % row_tiles) * blockDim.y + threadIdx.y) * R;
  const int c0 = NI * g;  // the first input column the thread owns
  const bool active = g < groups && i0 < ho;
  // the lane beside holds the neighbouring group of the same output rows
  const bool left_shfl = lane > 0 && threadIdx.x > 0;
  const bool right_shfl =
      lane < 31 && threadIdx.x + 1 < blockDim.x && g + 1 < groups;
  const bool left_load = active && !left_shfl && c0 > 0;
  const bool right_load = active && !right_shfl && c0 + NI < w;

  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    const T* xp = x + (size_t)p * h * w;
    T* yp = y + (size_t)p * ho * wo;
    uint4 q[NR][VEC ? NQ : 1];  // vector path: the rows as loaded
    float s[NR][VEC ? 1 : NI];  // scalar path: the rows as f32
    float el[NR], er[NR];       // the side columns, where loaded
#pragma unroll
    for (int k = 0; k < NR; ++k) {
      const int row = 2 * i0 - 1 + k;
      const bool ok = active && row >= 0 && row < h;
      const T* rp = xp + (size_t)(ok ? row : 0) * w + c0;
      if constexpr (VEC) {
#pragma unroll
        for (int v = 0; v < NQ; ++v)
          q[k][v] = ok ? __ldg(reinterpret_cast<const uint4*>(rp) + v)
                       : make_uint4(0, 0, 0, 0);
      } else {
#pragma unroll
        for (int e = 0; e < NI; ++e) s[k][e] = ok ? to_f32(rp[e]) : 0.f;
      }
      el[k] = ok && left_load ? to_f32(rp[-1]) : 0.f;
      er[k] = ok && right_load ? to_f32(rp[NI]) : 0.f;
    }
    auto in = [&](int k, int e) -> float {
      if constexpr (VEC) return elem<T>(q[k][e / EQ], e % EQ);
      else return s[k][e];
    };
#pragma unroll
    for (int m = 0; m < R; ++m) {
      // H pass: col[1 + e] is input column c0 + e filtered for row i0 + m
      float col[NI + 2];
#pragma unroll
      for (int e = 0; e < NI; ++e)
        col[1 + e] = tap4(taps.h, in(2 * m, e), in(2 * m + 1, e),
                          in(2 * m + 2, e), in(2 * m + 3, e));
      const float ls = __shfl_up_sync(mask, col[NI], 1);
      const float rs = __shfl_down_sync(mask, col[1], 1);
      col[0] = left_shfl ? ls
               : left_load ? tap4(taps.h, el[2 * m], el[2 * m + 1],
                                  el[2 * m + 2], el[2 * m + 3])
                           : 0.f;
      col[NI + 1] = right_shfl ? rs
                    : right_load ? tap4(taps.h, er[2 * m], er[2 * m + 1],
                                        er[2 * m + 2], er[2 * m + 3])
                                 : 0.f;
      if (!active || i0 + m >= ho) continue;
      // W pass: output column V*g + v reads col[2v .. 2v+3]
      float o[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        o[v] = tap4(taps.w, col[2 * v], col[2 * v + 1], col[2 * v + 2],
                    col[2 * v + 3]);
      T* op = yp + (size_t)(i0 + m) * wo + V * g;
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(op) = pack<T, V>(o);
      } else {
        op[0] = from_f32<T>(o[0]);
      }
    }
  }
}

// channels_last. Block: blockDim.x vectors of V channels x blockDim.y
// output columns, R output rows each, of one image; blockIdx.x = (row
// tile x col_tiles + column tile) x chan_tiles + channel tile, blockIdx.y
// the first image. The thread's R output rows are walked one at a time.
template <typename T, int V, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
fir_down2d_nhwc(const T* __restrict__ x, T* __restrict__ y, int images,
                int c, int h, int w, int ho, int wo, int groups,
                int chan_tiles, int col_tiles, Taps taps) {
  constexpr int R = kRowsNhwc;
  const int b = blockIdx.x / chan_tiles;
  const int g = (blockIdx.x % chan_tiles) * blockDim.x + threadIdx.x;
  const int j = (b % col_tiles) * blockDim.y + threadIdx.y;
  const int i0 = (b / col_tiles) * R;
  if (g >= groups || j >= wo) return;  // no shuffles below
  // input columns 2j-1+bb: 2j and 2j+1 lie inside (j < wo = w / 2), so
  // only the outer two are checked
  const bool col_ok[4] = {j > 0, true, true, 2 * j + 2 < w};
  for (int n = blockIdx.y; n < images; n += gridDim.y) {
    const T* xp = x + (size_t)n * h * w * c + V * g;
    T* yp = y + (size_t)n * ho * wo * c + V * g;
    // input pixels (row, 2j-1+bb), V channels each, 0 outside: slot r of
    // a two-row window, as loaded (vector path) or as f32 (scalar path)
    uint4 q[2][4];
    float s[2][4];
    auto load = [&](int r, int row) {
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const bool ok = col_ok[bb] && row >= 0 && row < h;
        const T* pp =
            xp + ((size_t)(ok ? row : 0) * w + (ok ? 2 * j - 1 + bb : 0)) * c;
        if constexpr (VEC) {
          q[r][bb] = ok ? __ldg(reinterpret_cast<const uint4*>(pp))
                        : make_uint4(0, 0, 0, 0);
        } else {
          s[r][bb] = ok ? to_f32(*pp) : 0.f;
        }
      }
    };
    auto at = [&](int r, int bb, int e) -> float {
      if constexpr (VEC) {
        return elem<T>(q[r][bb], e);
      } else {
        return s[r][bb];
      }
    };
    float part[4][V];
    load(0, 2 * i0 - 1);
    load(1, 2 * i0);
#pragma unroll
    for (int bb = 0; bb < 4; ++bb)
#pragma unroll
      for (int e = 0; e < V; ++e)
        part[bb][e] = __fadd_rn(__fmul_rn(taps.h[0], at(0, bb, e)),
                                __fmul_rn(taps.h[1], at(1, bb, e)));
#pragma unroll 1
    for (int m = 0; m < R && i0 + m < ho; ++m) {
      load(0, 2 * (i0 + m) + 1);
      load(1, 2 * (i0 + m) + 2);
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float col[4];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const float a = at(0, bb, e), d = at(1, bb, e);
          const float sum3 = __fadd_rn(part[bb][e], __fmul_rn(taps.h[2], a));
          col[bb] = col_ok[bb] ? __fadd_rn(sum3, __fmul_rn(taps.h[3], d))
                               : 0.f;
          part[bb][e] = __fadd_rn(__fmul_rn(taps.h[0], a),
                                  __fmul_rn(taps.h[1], d));
        }
        o[e] = tap4(taps.w, col[0], col[1], col[2], col[3]);
      }
      T* op = yp + ((size_t)(i0 + m) * wo + j) * c;
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(op) = pack<T, V>(o);
      } else {
        op[0] = from_f32<T>(o[0]);
      }
    }
  }
}

int ceil_div(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, bool VEC>
int launch(const void* x, void* y, int channels_last, int n, int c, int h,
           int w, int bx, int by, int64_t gx, int gy, const Taps& taps,
           cudaStream_t stream) {
  const int ho = h / 2, wo = w / 2;
  const dim3 grid((unsigned)gx, (unsigned)gy), block(bx, by);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  constexpr int V = VEC ? 16 / (int)sizeof(T) : 1;
  if (VEC && (!aligned(x) || !aligned(y))) return cudaErrorInvalidValue;
  if (!channels_last) {
    if (VEC && w % (2 * V)) return cudaErrorInvalidValue;
    const int groups = wo / V;
    const int row_tiles = ceil_div(ho, (int64_t)by * kRowsNchw);
    if (gx != (int64_t)row_tiles * ceil_div(groups, bx))
      return cudaErrorInvalidValue;
    fir_down2d_nchw<T, V, VEC><<<grid, block, 0, stream>>>(
        xt, yt, n * c, h, w, ho, wo, groups, row_tiles, taps);
  } else {
    if (VEC && c % V) return cudaErrorInvalidValue;
    const int groups = c / V;
    const int chan_tiles = ceil_div(groups, bx);
    const int col_tiles = ceil_div(wo, by);
    if (gx != (int64_t)chan_tiles * col_tiles * ceil_div(ho, kRowsNhwc))
      return cudaErrorInvalidValue;
    fir_down2d_nhwc<T, V, VEC><<<grid, block, 0, stream>>>(
        xt, yt, n, c, h, w, ho, wo, groups, chan_tiles, col_tiles, taps);
  }
  return cudaGetLastError();
}

template <typename T>
int launch_path(int vector, const void* x, void* y, int channels_last, int n,
                int c, int h, int w, int bx, int by, int64_t gx, int gy,
                const Taps& taps, cudaStream_t s) {
  return vector ? launch<T, true>(x, y, channels_last, n, c, h, w, bx, by,
                                  gx, gy, taps, s)
                : launch<T, false>(x, y, channels_last, n, c, h, w, bx, by,
                                   gx, gy, taps, s);
}

}  // namespace

// One launch of the plan made by ops/cuda_kernels.py:fir_down2d_plan.
// dtype: 0 = float32, 1 = bfloat16; channels_last: 0 = contiguous NCHW,
// 1 = channels_last strides; vector: 1 = 16-byte path, 0 = element path;
// block (bx, by), grid (gx, gy).
// taps points to 8 host floats (4 H taps, then 4 W taps, both flipped).
// Returns cudaErrorInvalidValue (1), launching nothing, when the plan does
// not fit the tensor (grid, block, alignment, W or C for the vector path,
// sizes past 32 bits); else cudaGetLastError() after the launch.
extern "C" int fir_down2d(const void* x, void* y, int dtype,
                          int channels_last, int vector, int64_t n,
                          int64_t c, int64_t h, int64_t w, int bx, int by,
                          int64_t gx, int gy, const float* taps,
                          void* stream) {
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
    return launch_path<float>(vector, x, y, channels_last, (int)n, (int)c,
                              (int)h, (int)w, bx, by, gx, gy, t, s);
  if (dtype == 1)
    return launch_path<__nv_bfloat16>(vector, x, y, channels_last, (int)n,
                                      (int)c, (int)h, (int)w, bx, by, gx, gy,
                                      t, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
