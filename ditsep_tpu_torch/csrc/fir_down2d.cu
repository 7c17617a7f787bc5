// fir_down2d: 4-tap separable FIR with 2x decimation on both spatial axes,
// in one pass, on a logical NCHW tensor (contiguous NCHW or channels_last).
//
// Replaces ditsep_tpu/ops/pallas_kernels.py:fir_down2_h_pallas and its
// wrapper downsample_2d_pallas, i.e. ditsep_tpu/ops/fir.py:downsample_2d(
// x, k, 2, gain) for a 4-tap k: pad (1, 1), taps flipped (a true
// convolution), H taps k/sum(k), W taps k/sum(k)*gain, output
// floor(H/2) x floor(W/2). Reads outside the input are zero (the pad).
//
// Bound on an H100: memory. Each output reads a 4x4 window (16 loads, 32
// flops) and inputs are read about once overall, so the least time is
//   bytes = (N*C*H*W + N*C*floor(H/2)*floor(W/2)) * sizeof(dtype)
// over the card's memory bandwidth (floor = ceil at the even sizes of the
// main path); the flops are far below the f32 rate.
//
// Design: one thread per output element computes its whole 4x4 window in
// registers (f32 accumulation for bf16 too) and writes once. The input is
// read once from device memory (neighbouring windows overlap in L1/L2) and
// no intermediate goes to device memory, unlike the TPU version, which ran
// two one-axis passes and materialised the H-filtered tensor and four
// strided views in between. Thread order follows the output's memory
// order, so stores are coalesced in both layouts. Vectorised 16-byte loads
// for channels_last and shared-memory row tiles are left for later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  float h[4];  // flipped H taps: row 2i-1+a is weighted by h[a]
  float w[4];  // flipped W taps (gain folded in): col 2j-1+b by w[b]
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void fir_down2d_kernel(const T* __restrict__ x, T* __restrict__ y,
                                  int64_t n, int64_t c, int64_t h, int64_t w,
                                  int64_t sn, int64_t sc, int64_t sh,
                                  int64_t sw, int channels_last, Taps taps) {
  const int64_t ho = h / 2, wo = w / 2;
  const int64_t total = n * c * ho * wo;
  for (int64_t o = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; o < total;
       o += (int64_t)gridDim.x * blockDim.x) {
    // o is the output's memory offset; decompose it in that memory order
    int64_t r = o, in, ic, i, j;
    if (channels_last) {
      ic = r % c; r /= c;
      j = r % wo; r /= wo;
      i = r % ho; in = r / ho;
    } else {
      j = r % wo; r /= wo;
      i = r % ho; r /= ho;
      ic = r % c; in = r / c;
    }
    const T* base = x + in * sn + ic * sc;
    // H pass inside each column, then the W pass: the order of the
    // plain version (downsample_2d_plain), so f32 results agree closely
    float acc = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int64_t col = 2 * j - 1 + b;
      if (col < 0 || col >= w) continue;
      float colsum = 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int64_t row = 2 * i - 1 + a;
        if (row < 0 || row >= h) continue;
        colsum += taps.h[a] * load_f32(base + row * sh + col * sw);
      }
      acc += taps.w[b] * colsum;
    }
    store(y + o, acc);
  }
}

template <typename T>
void launch(const void* x, void* y, int64_t n, int64_t c, int64_t h,
            int64_t w, int64_t sn, int64_t sc, int64_t sh, int64_t sw,
            int channels_last, const Taps& taps, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = n * c * (h / 2) * (w / 2);
  int64_t blocks = (total + threads - 1) / threads;
  const int64_t max_blocks = 132 * 64;  // grid-stride beyond ~8 waves
  if (blocks > max_blocks) blocks = max_blocks;
  fir_down2d_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, c, h, w, sn, sc, sh,
      sw, channels_last, taps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. taps points
// to 8 host floats (4 H taps, then 4 W taps, both already flipped).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fir_down2d(const void* x, void* y, int dtype, int64_t n,
                          int64_t c, int64_t h, int64_t w, int64_t sn,
                          int64_t sc, int64_t sh, int64_t sw,
                          int channels_last, const float* taps,
                          void* stream) {
  Taps t;
  for (int k = 0; k < 4; ++k) {
    t.h[k] = taps[k];
    t.w[k] = taps[4 + k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, y, n, c, h, w, sn, sc, sh, sw, channels_last, t, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, y, n, c, h, w, sn, sc, sh, sw, channels_last, t,
                          s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
