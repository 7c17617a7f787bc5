// fused_bias_act: out = leaky_relu(x + bias, slope) * scale (forward) and
// dx = g * (x + bias >= 0 ? scale : slope * scale) (backward), with the bias
// broadcast over one channel axis: the last (rows x C, the TPU contract)
// or axis 1 of an NCHW-like tensor (the port's own layout).
//
// Replaces ditsep_tpu/ops/pallas_kernels.py:_fba_fwd_kernel (through
// fused_bias_act_pallas / _fba_forward) and :_fba_bwd_kernel (through
// _fba_bwd). As there, the backward recomputes the sign from x + bias and
// keeps no mask buffer; dbias = sum(dx) is taken outside the kernel.
//
// Bound on an H100: memory. Each element costs one add, one compare and
// one or two multiplies against 2 (forward) or 3 (backward) element
// accesses, so the least time is the bytes over the card's bandwidth:
//   forward  (numel_x + numel_out) * sizeof(dtype) + C * sizeof(dtype)
//   backward (numel_x + numel_g + numel_dx) * sizeof(dtype) + C * ...
//
// Design: the tensor is walked as a flat array with 32-bit indices (the
// wrapper raises at 2^31 elements), each thread taking one 16-byte vector
// (4 f32 or 8 bf16) per step of a grid-stride loop, so every load and
// store is a full 16-byte access. The vector path needs the channel to be
// constant along the vector (axis 1: inner size a multiple of the vector)
// or consecutive (last axis: C a multiple of the vector) and 16-byte
// aligned pointers; other shapes run the same code one element at a time.
// Arithmetic is f32, rounded once to the output type. The bias (C values)
// is read through the read-only cache and stays in L1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// channel of flat element i: (i / inner) % C; inner == 1 for the last axis
template <typename T, int VEC, bool LAST>
__device__ __forceinline__ void channels(uint32_t i, uint32_t inner,
                                         uint32_t c, const T* __restrict__ b,
                                         float* bias) {
  if (LAST) {
    const uint32_t c0 = i % c;  // C % VEC == 0: the vector stays in a row
#pragma unroll
    for (int k = 0; k < VEC; ++k) bias[k] = to_f32(b[c0 + k]);
  } else {
    const float bv = to_f32(b[(i / inner) % c]);  // inner % VEC == 0
#pragma unroll
    for (int k = 0; k < VEC; ++k) bias[k] = bv;
  }
}

template <typename T, int VEC, bool LAST>
__global__ void fba_fwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ b, T* __restrict__ y,
                               uint32_t n_vec, uint32_t inner, uint32_t c,
                               float slope, float scale) {
  using V = Vec<T, VEC>;
  for (uint32_t v = blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += gridDim.x * blockDim.x) {
    float bias[VEC];
    channels<T, VEC, LAST>(v * VEC, inner, c, b, bias);
    const V xv = reinterpret_cast<const V*>(x)[v];
    V out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float s = to_f32(xv.v[k]) + bias[k];
      out.v[k] = from_f32<T>((s >= 0.f ? s : slope * s) * scale);
    }
    reinterpret_cast<V*>(y)[v] = out;
  }
}

template <typename T, int VEC, bool LAST>
__global__ void fba_bwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ b,
                               const T* __restrict__ g, T* __restrict__ dx,
                               uint32_t n_vec, uint32_t inner, uint32_t c,
                               float scale, float neg_scale) {
  using V = Vec<T, VEC>;
  for (uint32_t v = blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += gridDim.x * blockDim.x) {
    float bias[VEC];
    channels<T, VEC, LAST>(v * VEC, inner, c, b, bias);
    const V xv = reinterpret_cast<const V*>(x)[v];
    const V gv = reinterpret_cast<const V*>(g)[v];
    V out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float s = to_f32(xv.v[k]) + bias[k];
      const float d = s >= 0.f ? scale : neg_scale;
      out.v[k] = from_f32<T>(to_f32(gv.v[k]) * d);
    }
    reinterpret_cast<V*>(dx)[v] = out;
  }
}

// Up to 32 blocks of `threads` per SM of the current device (the wrapper
// makes the tensor's device current); the grid-stride loop covers the rest.
unsigned grid_for(uint32_t n_vec, int threads) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    sms = 1;  // any error stays pending for the caller's cudaGetLastError
  const uint32_t max_blocks = (uint32_t)sms * 32;
  uint32_t blocks = (n_vec + threads - 1) / threads;
  return blocks < max_blocks ? (blocks ? blocks : 1) : max_blocks;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Launch the vector form when the layout allows it, else the scalar form.
// Forward: g == nullptr, (p0, p1) = (slope, scale). Backward: g given,
// (p0, p1) = (scale, slope * scale).
template <typename T>
void launch(const void* x, const void* b, const void* g, void* out,
            uint32_t numel, uint32_t inner, uint32_t c, float p0, float p1,
            cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int threads = 256;
  const bool last = inner == 1;
  const bool vec = (last ? c % VEC == 0 : inner % VEC == 0) &&
                   aligned16(x) && aligned16(out) && (!g || aligned16(g));
  const uint32_t n_vec = vec ? numel / VEC : numel;
  const unsigned blocks = grid_for(n_vec, threads);
  const T* xs = static_cast<const T*>(x);
  const T* bs = static_cast<const T*>(b);
  T* os = static_cast<T*>(out);
#define FBA_LAUNCH(V, L)                                                     \
  if (g)                                                                     \
    fba_bwd_kernel<T, V, L><<<blocks, threads, 0, stream>>>(                 \
        xs, bs, static_cast<const T*>(g), os, n_vec, inner, c, p0, p1);      \
  else                                                                       \
    fba_fwd_kernel<T, V, L><<<blocks, threads, 0, stream>>>(                 \
        xs, bs, os, n_vec, inner, c, p0, p1);
  if (vec && last) {
    FBA_LAUNCH(VEC, true)
  } else if (vec) {
    FBA_LAUNCH(VEC, false)
  } else if (last) {
    FBA_LAUNCH(1, true)
  } else {
    FBA_LAUNCH(1, false)
  }
#undef FBA_LAUNCH
}

int dispatch(int dtype, const void* x, const void* b, const void* g,
             void* out, int64_t numel, int64_t inner, int64_t c, float p0,
             float p1, void* stream) {
  if (numel <= 0 || numel >= (int64_t(1) << 31) || inner <= 0 || c <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, b, g, out, (uint32_t)numel, (uint32_t)inner,
                  (uint32_t)c, p0, p1, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, b, g, out, (uint32_t)numel, (uint32_t)inner,
                          (uint32_t)c, p0, p1, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, bias and the output share it).
// x is contiguous with numel elements; the channel of flat element i is
// (i / inner) % c: inner = 1 for a last channel axis, H*W for NCHW.
// The backward takes scale and neg_scale = slope * scale (the caller
// rounds the product to f32 once, as the plain version does).
// Each returns cudaGetLastError() after the launch (0 on success).
extern "C" int fba_fwd(const void* x, const void* bias, void* y, int dtype,
                       int64_t numel, int64_t inner, int64_t c, float slope,
                       float scale, void* stream) {
  return dispatch(dtype, x, bias, nullptr, y, numel, inner, c, slope, scale,
                  stream);
}

extern "C" int fba_bwd(const void* x, const void* bias, const void* g,
                       void* dx, int dtype, int64_t numel, int64_t inner,
                       int64_t c, float scale, float neg_scale,
                       void* stream) {
  return dispatch(dtype, x, bias, g, dx, numel, inner, c, scale, neg_scale,
                  stream);
}
