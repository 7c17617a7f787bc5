// conv3x3: a 3x3 convolution as an implicit GEMM on the tensor cores, bf16
// in, f32 accumulation, bf16 out, on a zero-bordered NHWC layout that is
// closed under the op.
//
// Layout: x (B, H+2, W+2*padw, C) with zero borders, w (9, C, C2) (tap
// ky*3+kx, JAX's weight layout), y (B, H+2, W+2*padw, C2):
//   y[b, 1+i, padw+j, :] = sum_{ky,kx} x[b, i+ky, padw-1+j+kx, :] @ w[ky*3+kx]
// and every border element of y (rows 0 and H+1, padw columns on each
// side) is written as an exact zero.
//
// Two entry points:
//   conv3x3_9tap       replaces scripts/pallas_conv_probe.py:_conv_kernel
//                      (through conv3x3_pallas), padw = 1;
//   conv3x3_async_halo replaces scripts/pallas_conv_probe.py:_conv_dma_kernel
//                      (through conv3x3_pallas_dma), padw = 4 there.
//
// Bound on an H100: operations. At the probe's shape (B=16, 576x256,
// 128->128) the conv does 2*B*H*W*C*C2*9 = 6.96e11 FLOP, 0.704 ms at the
// 989 TFLOP/s bf16 dense peak, while its bytes (input and output once,
// 1.22 GB) take 0.365 ms at 3.35 TB/s.
//
// Design (simple first; wgmma and TMA are for later work):
// - One block of 16 warps owns an output tile of TH x TW = 16 x 16 pixels
//   (M = 256 GEMM rows) and all C2 channels, in passes of up to 128.
// - Its input tile with the 1-pixel halo, (TH+2) x (TW+2) x C, is copied
//   once into shared memory, rows padded by 8 elements so that the eight
//   16-byte rows of each ldmatrix phase fall in distinct banks; the 9 taps
//   are 9 shifted views of it, so tap (ky, kx) of tile row r is a 16-pixel
//   row of the halo tile: an A operand that needs no im2col.
// - The weights (9 x C x C2 bf16 = 295 KB at C = C2 = 128, more than a
//   block's shared memory) stream through a double buffer in chunks of KC
//   input channels of one tap: the next chunk is loaded into registers
//   while the tensor cores work on the current one, then stored. The
//   256-pixel tile reads them once per 256 outputs.
// - Products are mma.sync m16n8k16 (bf16 in, f32 accumulators) on
//   fragments loaded with ldmatrix (.trans for the row-major weights); a
//   warp owns 2 x 8 of them (32 pixels x 64 channels), within the 128
//   registers a thread that 512 threads leave.
// - The epilogue goes through a per-warp staging tile in the idle weight
//   buffer: f32 -> bf16 (round to nearest even, once), then 16-byte stores
//   of whole 8-channel runs.
// - conv3x3_9tap: one tile per block, loaded with plain 16-byte loads
//   (122.9 KB of shared memory at C = 128).
//   conv3x3_async_halo: each block walks several row tiles of one image
//   (the TPU's sequential grid becomes a loop) and prefetches tile s+1's
//   halo window with cp.async (16-byte, zero-fill past the edge) into a
//   second buffer while it computes tile s (211.1 KB at C = 128).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TH = 16, TW = 16;       // output tile: 16 rows x 16 columns
constexpr int THREADS = 512;          // 16 warps: 8 along M x 2 along N
constexpr int NC_MAX = 128;           // output channels per pass
constexpr int KC_MAX = 64;            // input channels per weight chunk
constexpr int PAD = 8;                // smem row padding, elements
constexpr int WS = NC_MAX + PAD;      // weight chunk row stride, elements
constexpr int ST = 64;                // epilogue staging row, elements
constexpr int HALO_PIX = (TH + 2) * (TW + 2);
constexpr int W_REGS = KC_MAX * NC_MAX / 8 / THREADS;  // uint4 per thread

struct Params {
  const bf16* x;
  const bf16* w;
  bf16* y;
  int h, w_out, c, c2, padw, hp, wp;  // w_out: interior width W
  int n_row_tiles, n_col_tiles, rows_per_block, kc;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Copy the halo window of row tile ti, column tile tj of image xb into
// smem (row stride cs elements). Pixels past the input's interior+border
// are zeros. ASYNC: issue cp.async (the caller commits and waits).
template <bool ASYNC>
__device__ void load_halo(const Params& p, const bf16* xb, bf16* halo,
                          int ti, int tj) {
  const int cs = p.c + PAD, chunks = p.c / 8;
  const int r0 = ti * TH, c0 = p.padw - 1 + tj * TW;
  const int col_end = p.padw + p.w_out + 1;  // last column read + 1
  for (int idx = threadIdx.x; idx < HALO_PIX * chunks; idx += THREADS) {
    const int pix = idx / chunks, ch = idx - pix * chunks;
    const int hr = pix / (TW + 2), hc = pix - hr * (TW + 2);
    const int pr = r0 + hr, pc = c0 + hc;
    const bool valid = pr < p.hp && pc < col_end;
    const bf16* src = valid ? xb + ((size_t)pr * p.wp + pc) * p.c + ch * 8
                            : xb;
    bf16* dst = halo + pix * cs + ch * 8;
    if (ASYNC) {
      cp_async16(dst, src, valid);
    } else {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (valid) v = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(dst) = v;
    }
  }
}

// Zero the pixels [r0, r1) x [c0, c1) of image yb, all C2 channels.
__device__ void zero_rect(const Params& p, bf16* yb, int r0, int r1, int c0,
                          int c1) {
  const int chunks = p.c2 / 8, cols = c1 - c0;
  const int n = (r1 - r0) * cols * chunks;
  for (int idx = threadIdx.x; idx < n; idx += THREADS) {
    const int pix = idx / chunks, ch = idx - pix * chunks;
    const int r = r0 + pix / cols, c = c0 + pix % cols;
    *reinterpret_cast<uint4*>(yb + ((size_t)r * p.wp + c) * p.c2 + ch * 8) =
        make_uint4(0, 0, 0, 0);
  }
}

// The border pixels of y that tile (ti, tj) owns: the top/bottom row
// across its columns (the corner tiles out to the edge), the padw side
// columns beside its rows.
__device__ void zero_borders(const Params& p, bf16* yb, int ti, int tj) {
  const int j0 = tj * TW, i0 = ti * TH;
  const int cl = tj == 0 ? 0 : p.padw + j0;
  const int cr = tj == p.n_col_tiles - 1 ? p.wp : p.padw + j0 + TW;
  if (ti == 0) zero_rect(p, yb, 0, 1, cl, cr);
  if (ti == p.n_row_tiles - 1) zero_rect(p, yb, p.hp - 1, p.hp, cl, cr);
  const int rb = 1 + i0, re = 1 + min(i0 + TH, p.h);
  if (tj == 0) zero_rect(p, yb, rb, re, 0, p.padw);
  if (tj == p.n_col_tiles - 1)
    zero_rect(p, yb, rb, re, p.padw + p.w_out, p.wp);
}

// Weight chunk s (tap s / nkc, input channels (s % nkc) * kc + [0, kc)),
// output channels nb + [0, nc): global -> registers, registers -> smem.
__device__ __forceinline__ void load_w_regs(const Params& p, int s, int nb,
                                            int nc, uint4* regs) {
  const int nkc = p.c / p.kc, tap = s / nkc, k0 = (s - tap * nkc) * p.kc;
  const int chunks = nc / 8;
#pragma unroll
  for (int r = 0; r < W_REGS; ++r) {
    const int idx = threadIdx.x + r * THREADS;
    if (idx < p.kc * chunks) {
      const int row = idx / chunks, ch = idx - row * chunks;
      regs[r] = *reinterpret_cast<const uint4*>(
          p.w + ((size_t)(tap * p.c + k0 + row) * p.c2 + nb + ch * 8));
    }
  }
}
__device__ __forceinline__ void store_w_regs(const Params& p, int nc,
                                             const uint4* regs, bf16* buf) {
  const int chunks = nc / 8;
#pragma unroll
  for (int r = 0; r < W_REGS; ++r) {
    const int idx = threadIdx.x + r * THREADS;
    if (idx < p.kc * chunks) {
      const int row = idx / chunks, ch = idx - row * chunks;
      *reinterpret_cast<uint4*>(buf + row * WS + ch * 8) = regs[r];
    }
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// four 8x8 b16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8, and gets fragment register i from matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c (16x8 f32) += a (16x16 bf16, row-major) @ b (16x8 bf16, col-major)
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One output tile from its halo tile in smem: all C2 channels. A warp
// owns tile rows 2*wm, 2*wm+1 (two 16-pixel m16 fragments) and output
// channels wn*64 + [0, 64) of each pass (eight n8 fragments).
__device__ void compute_tile(const Params& p, const bf16* halo, bf16* wbuf,
                             bf16* yb, int ti, int tj) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp % 8, wn = warp / 8;
  const int cs = p.c + PAD, nkc = p.c / p.kc, n_stages = 9 * nkc;
  // ldmatrix rows of this lane: pixel / k row lane % 16, column half
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  for (int nb = 0; nb < p.c2; nb += NC_MAX) {
    const int nc = min(NC_MAX, p.c2 - nb);
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mi][t][k] = 0.f;
    uint4 regs[W_REGS];
    load_w_regs(p, 0, nb, nc, regs);
    store_w_regs(p, nc, regs, wbuf);
    __syncthreads();
    for (int s = 0; s < n_stages; ++s) {
      const bf16* cur = wbuf + (s & 1) * KC_MAX * WS;
      if (s + 1 < n_stages) load_w_regs(p, s + 1, nb, nc, regs);
      const int tap = s / nkc, k0 = (s - tap * nkc) * p.kc;
      const int ky = tap / 3, kx = tap - ky * 3;
      // tile row r, tap (ky, kx): halo row r + ky from column kx on
      const bf16* a_base =
          halo + ((wm * 2 + ky) * (TW + 2) + kx + lrow) * cs + k0 + lcol;
      const bf16* b_base = cur + lrow * WS + wn * 64 + lcol;
      for (int kk = 0; kk < p.kc; kk += 16) {
        uint32_t a[2][4];
        ldmatrix_x4(a[0], a_base + kk);
        ldmatrix_x4(a[1], a_base + (TW + 2) * cs + kk);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (wn * 64 + jp * 16 < nc) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, b_base + kk * WS + jp * 16);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              mma_16816(acc[mi][2 * jp], a[mi], b[0], b[1]);
              mma_16816(acc[mi][2 * jp + 1], a[mi], b[2], b[3]);
            }
          }
        }
      }
      if (s + 1 < n_stages)
        store_w_regs(p, nc, regs, wbuf + ((s + 1) & 1) * KC_MAX * WS);
      __syncthreads();
    }
    // epilogue through this warp's staging tile in the (now idle) weight
    // buffer: f32 -> bf16 once, then 16-byte stores of whole 8-channel
    // runs. 16-byte chunk c of staging row r sits at c ^ (r % 8), so the
    // 8 rows a store instruction touches fall in distinct banks.
    bf16* st = wbuf + warp * 16 * ST;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int r = lane >> 2, off = (lane & 3) * 2;
        *reinterpret_cast<__nv_bfloat162*>(
            st + r * ST + ((t ^ (r & 7)) * 8) + off) =
            __floats2bfloat162_rn(acc[mi][t][0], acc[mi][t][1]);
        *reinterpret_cast<__nv_bfloat162*>(
            st + (r + 8) * ST + ((t ^ (r & 7)) * 8) + off) =
            __floats2bfloat162_rn(acc[mi][t][2], acc[mi][t][3]);
      }
      __syncwarp();
      const int i = ti * TH + wm * 2 + mi;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int q = lane + 32 * k, px = q >> 3, c8 = q & 7;
        const int j = tj * TW + px, n = wn * 64 + c8 * 8;
        if (i < p.h && j < p.w_out && n < nc)
          *reinterpret_cast<uint4*>(
              yb + ((size_t)(1 + i) * p.wp + p.padw + j) * p.c2 + nb + n) =
              *reinterpret_cast<const uint4*>(
                  st + px * ST + (c8 ^ (px & 7)) * 8);
      }
      __syncwarp();
    }
    __syncthreads();  // the staging tiles alias the next pass's weights
  }
}

// grid (n_col_tiles, ceil(n_row_tiles / rows_per_block), B); the block
// takes row tiles [y * rows_per_block, ...) of column tile x, image z.
template <bool ASYNC>
__global__ void __launch_bounds__(THREADS)
    conv3x3_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  static_assert(THREADS / 32 * 16 * ST <= 2 * KC_MAX * WS,
                "the epilogue's staging tiles fit in the weight buffers");
  const int halo_elems = HALO_PIX * (p.c + PAD);
  bf16* halo[2];
  halo[0] = reinterpret_cast<bf16*>(smem);
  halo[1] = halo[0] + (ASYNC ? halo_elems : 0);
  bf16* wbuf = halo[0] + (ASYNC ? 2 : 1) * halo_elems;

  const int tj = blockIdx.x, b = blockIdx.z;
  const int t0 = blockIdx.y * p.rows_per_block;
  const int t1 = min(t0 + p.rows_per_block, p.n_row_tiles);
  const bf16* xb = p.x + (size_t)b * p.hp * p.wp * p.c;
  bf16* yb = p.y + (size_t)b * p.hp * p.wp * p.c2;

  if (ASYNC) {
    load_halo<true>(p, xb, halo[0], t0, tj);
    cp_async_commit();
  }
  for (int ti = t0; ti < t1; ++ti) {
    const bf16* cur = halo[(ti - t0) & 1];
    if (ASYNC) {
      if (ti + 1 < t1) {  // the next window lands while this one computes
        load_halo<true>(p, xb, halo[(ti + 1 - t0) & 1], ti + 1, tj);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else {
      load_halo<false>(p, xb, halo[0], ti, tj);
    }
    // compute_tile syncs before its first read of the halo tile
    zero_borders(p, yb, ti, tj);
    compute_tile(p, cur, wbuf, yb, ti, tj);
  }
}

size_t smem_bytes(int c, bool async) {
  const size_t halo = (size_t)HALO_PIX * (c + PAD) * sizeof(bf16);
  return (async ? 2 : 1) * halo + 2 * KC_MAX * WS * sizeof(bf16);
}

template <bool ASYNC>
int launch(const void* x, const void* w, void* y, int64_t b, int64_t hp,
           int64_t wp, int64_t c, int64_t c2, int64_t padw,
           int64_t rows_per_block, void* stream) {
  const int64_t h = hp - 2, w_out = wp - 2 * padw;
  if (b < 1 || h < 1 || w_out < 1 || padw < 1 || c < 16 || c2 < 16 ||
      c % 16 || c2 % 16 || b > 65535 ||
      b * hp * wp * (c > c2 ? c : c2) >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes((int)c, ASYNC);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<ASYNC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.y = static_cast<bf16*>(y);
  p.h = (int)h;
  p.w_out = (int)w_out;
  p.c = (int)c;
  p.c2 = (int)c2;
  p.padw = (int)padw;
  p.hp = (int)hp;
  p.wp = (int)wp;
  p.n_row_tiles = (int)((h + TH - 1) / TH);
  p.n_col_tiles = (int)((w_out + TW - 1) / TW);
  p.rows_per_block = (int)rows_per_block;
  p.kc = c % 64 == 0 ? 64 : (c % 32 == 0 ? 32 : 16);
  const dim3 grid(p.n_col_tiles,
                  (p.n_row_tiles + p.rows_per_block - 1) / p.rows_per_block,
                  (unsigned)b);
  conv3x3_kernel<ASYNC><<<grid, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, hp, wp, C), w (9, C, C2), y (B, hp, wp, C2): contiguous bf16,
// 16-byte aligned; C and C2 multiples of 16. Each returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int conv3x3_9tap(const void* x, const void* w, void* y,
                            int64_t b, int64_t hp, int64_t wp, int64_t c,
                            int64_t c2, void* stream) {
  return launch<false>(x, w, y, b, hp, wp, c, c2, 1, 1, stream);
}

// rows_per_block: row tiles (of TH = 16 rows) each block walks,
// prefetching the next one's halo window while it computes the current.
extern "C" int conv3x3_async_halo(const void* x, const void* w, void* y,
                                  int64_t b, int64_t hp, int64_t wp,
                                  int64_t c, int64_t c2, int64_t padw,
                                  int64_t rows_per_block, void* stream) {
  if (rows_per_block < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(x, w, y, b, hp, wp, c, c2, padw, rows_per_block,
                      stream);
}
