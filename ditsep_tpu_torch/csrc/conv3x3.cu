// conv3x3: a 3x3 convolution as an implicit GEMM on Hopper's tensor cores,
// bf16 in, f32 accumulation, bf16 out, on a zero-bordered NHWC layout that
// is closed under the op.
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
// They share everything but the way the halo arrives, as the TPU pair did.
//
// Bound on an H100: operations. At the probe's shape (B=16, 576x256,
// 128->128) the conv does 2*B*H*W*C*C2*9 = 6.96e11 FLOP, 0.704 ms at the
// 989 TFLOP/s bf16 dense peak, while its bytes (input and output once,
// 1.22 GB) take 0.365 ms at 3.35 TB/s. What binds this design first is
// shared memory: every k16 step of a wgmma m64nNS reads its A (64 pixels)
// and its B (the slice) from shared memory, 1/16 byte a multiply-add at
// NS = 64, which at the tensor cores' peak is about all of the 128 bytes a
// clock an SM's shared memory delivers.
//
// Design:
// - Persistent grid (the wrapper passes the CTA count: one a SM, rounded
//   down to a multiple of the slice count, by default). The work is (M
//   tile, slice) items: an M tile is TH x TW = 8 x 16 output pixels of
//   one image (128 GEMM rows), a slice NS output channels (64; 32 or 16
//   where shared memory is short). CTA i takes items i, i + grid, ... with
//   the slice fastest, so with the default grid a CTA keeps one slice for
//   the whole launch and the CTAs of one M tile run side by side (the
//   second halo read hits L2). Each item is computed by one CTA in a fixed
//   order, so the output does not depend on the grid.
// - The slice's weights, 9 x kp x NS bf16 (kp: C padded with zeros to a
//   multiple of 64; 144 KiB at C = 128, NS = 64), stay in shared memory:
//   loaded once with plain 16-byte loads into the wgmma B layout (rows of
//   NS N-contiguous elements, swizzled by NS*2 bytes), again only when a
//   CTA's slice changes.
// - Products: wgmma.mma_async m64 x NS x k16 with both operands read from
//   shared memory by descriptor: B the slice (transpose-B: w9's rows are
//   N-contiguous), A the halo. Warpgroup g of the two consumer warpgroups
//   owns columns 8g + [0, 8) of the M tile, so its 64 pixels are 8 halo
//   rows of 8: tap (ky, kx) is the same descriptor moved by ky rows and kx
//   pixels, no im2col. The halo is kept in 64-channel blocks of 128-byte
//   pixel rows, 128B-swizzled. The K loop runs over blocks, then taps: 4
//   wgmmas a tap, committed as a group, with nothing to wait for between
//   groups. K is padded so that no wgmma is conditional (ptxas would
//   serialize them).
// - Epilogue: f32 -> bf16 once, through the warp's swizzled staging tile,
//   then 16-byte stores of whole 8-channel runs; the CTA of a slice writes
//   the border pixels its M tile owns in the slice's channels.
// - conv3x3_9tap: each warpgroup keeps its own 10 x 10 halo (all blocks)
//   and fills it with plain 16-byte loads by its 128 threads, a block at a
//   time: the loads of the next block go out when a block starts, into
//   registers (7 a thread), and are stored to shared memory behind a
//   barrier of the warpgroup's own when that block starts (218.1 KB at C =
//   128). Warpgroup 1 starts a block after warpgroup 0, so that one's
//   barriers and epilogue fall in the other's products.
//   conv3x3_async_halo: a producer warpgroup (one thread issues; its
//   registers go to the consumers by setmaxnreg, 40 against 232) keeps TMA
//   loads of the halo in flight into a two-stage mbarrier ring. A stage is
//   a 64-channel block of the tile's 10 x 18 halo (box 64 x 18 x 10,
//   128B-swizzled, zero-filled out of bounds), so channels 64-127 of tile
//   t land while 0-63 compute, and tile t+1's first block while 64-127
//   compute (212.0 KB at C = 128). A stage goes back to the producer when
//   the wgmmas that read it are done.
#include <cuda.h>  // CUtensorMap (types only: the driver is reached through cudart)
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TH = 8, TW = 16;                 // output tile: 8 rows x 16 columns
constexpr int HALO_H = TH + 2, HALO_W = TW + 2;  // async: the tile's halo
constexpr int HALO_PIX = HALO_H * HALO_W;      // 180 pixels
constexpr int WG_W = TW / 2 + 2;               // 9-tap: a warpgroup's halo columns
constexpr int WG_PIX = HALO_H * WG_W;          // 100 pixels
constexpr int CONSUMERS = 256;                 // two warpgroups
constexpr int KB = 64;                         // input channels a halo block
constexpr int STAGES = 2;
constexpr int STAGE_TX = HALO_PIX * KB * 2;    // 23,040 bytes a TMA box
constexpr int STAGE_BYTES = 23552;             // rounded up to 1 KiB (the swizzle atom)
constexpr int WG_BLOCK_BYTES = 13312;          // 9-tap: 12,800 bytes to 1 KiB
constexpr int SMEM_LIMIT = 232448;
constexpr int ALIGN = 1024;                    // slack to align the base

struct Params {
  const bf16* x;
  const bf16* w;
  bf16* y;
  int h, w_out, c, c2, padw, hp, wp;           // w_out: interior width W
  int kp;                                      // C rounded up to KB
  int n_row_tiles, n_col_tiles, n_tiles, n_slices;
  int halo_off, stg_off, bar_off;              // shared-memory offsets, bytes
};

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Shared memory of one CTA: the weight slice at offset 0, then the two
// warpgroups' halos (9-tap) or the ring's stages (async), the staging
// tiles, the barriers. The wrapper's conv3x3_plan computes the same total.
struct Layout {
  int halo_off, stg_off, bar_off, total;
};
Layout smem_layout(int c, int ns, bool async) {
  Layout l{};
  const int kp = round_up(c, KB);
  const int wbytes = round_up(9 * kp * ns * 2, 1024);
  l.halo_off = wbytes;
  l.stg_off = wbytes + (async ? STAGES * STAGE_BYTES
                              : 2 * (kp / KB) * WG_BLOCK_BYTES);
  l.bar_off = l.stg_off + TH * TW * ns * 2;
  l.total = l.bar_off + (async ? 2 * STAGES * 8 : 0) + ALIGN;
  return l;
}

// ------------------------------------------------------------- PTX wrappers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// a 16-byte load that stays where it is written (volatile: the compiler
// neither sinks it towards its use nor hoists it across the wgmmas)
__device__ __forceinline__ void ld_global_v4(uint4& v, const void* src) {
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(src));
}
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
}
// the 128 threads of warpgroup g
__device__ __forceinline__ void wg_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + g) : "memory");
}
// 9-tap: warpgroup 1 starts once warpgroup 0 is a block ahead (barrier 4)
__device__ __forceinline__ void stagger_arrive() {
  asm volatile("bar.arrive 4, %0;\n" :: "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void stagger_wait() {
  asm volatile("bar.sync 4, %0;\n" :: "n"(CONSUMERS) : "memory");
}
// generic-proxy writes to shared memory -> visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}
// box (c0, c1, c2, c3) of the tensor map -> shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// the accumulators are live across this point (keeps the compiler from
// reading them before the wgmma that writes them has been waited for)
template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// 128B-swizzled byte offset (16-byte chunk bits 4-6 XOR row bits 7-9)
__device__ __forceinline__ uint32_t swizzle128(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
}
// Descriptor of A: 64 halo pixels (8 groups of 8) x 16 channels at `addr`
// in a 64-channel halo block: 128-byte pixel rows, K-major,
// 128B-swizzled; groups PITCH pixels (a halo row) apart. The hardware
// swizzles by the absolute address, as TMA and swizzle128 write, so a
// start inside a 1024-byte atom needs no base offset.
template <int PITCH>
__device__ __forceinline__ uint64_t a_desc(uint32_t addr) {
  constexpr uint64_t sbo = PITCH * 128 / 16;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (sbo << 32) | (1ull << 62);
}
// Descriptor of a K16 x NS block of the weight slice at `addr`: rows of NS
// N-contiguous bf16 (MN-major), NS * 2 bytes each, swizzled by that width
// (128B, 64B, 32B); 8 rows apart by SBO = 8 * NS * 2 bytes. The slice fills
// one swizzle atom along N, so the leading offset is never used.
template <int NS>
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  constexpr uint64_t layout = NS == 64 ? 1 : (NS == 32 ? 2 : 3);
  constexpr uint64_t sbo = 8 * NS * 2 / 16;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (sbo << 32) | (layout << 62);
}
// byte offset `off` of the weight slice -> its swizzled offset (Swizzle<B,4,3>:
// 16-byte chunk bits 4.. XOR row bits 7..; mask 7, 3, 1 for NS 64, 32, 16)
template <int NS>
__device__ __forceinline__ uint32_t w_swizzle(uint32_t off) {
  constexpr uint32_t mask = NS / 8 - 1;
  return off ^ (((off >> 7) & mask) << 4);
}

// d (64 x NS f32, this thread's NS / 2) (+)= A (64 x 16 bf16, descriptor
// da, K-major) @ B (16 x NS, descriptor db, transposed); scale_d = 0
// overwrites d
template <int NS>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_ss<16>(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ------------------------------------------------------------ data movement
// Output channels nb + [0, NS) of w9 -> the weight slice at `ws`: row
// tap * kp + k holds w9[tap, k, nb:nb+NS], zeros past C and past C2.
template <int NS>
__device__ void load_weights(const Params& p, unsigned char* ws, int nb,
                             int tid) {
  constexpr int CH = NS / 8;  // 16-byte chunks a row
  const int n = 9 * p.kp * CH;
  for (int idx = tid; idx < n; idx += CONSUMERS) {
    const int r = idx / CH, ch = idx % CH, col = nb + ch * 8;
    const int tap = r / p.kp, k = r - tap * p.kp;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (col < p.c2 && k < p.c)
      v = __ldg(reinterpret_cast<const uint4*>(
          p.w + (size_t)(tap * p.c + k) * p.c2 + col));
    *reinterpret_cast<uint4*>(ws + w_swizzle<NS>(r * NS * 2 + ch * 16)) = v;
  }
}

// 9-tap: 64-channel block kb of warpgroup g's halo of an M tile (10 x 10
// pixels, columns 8g + [0, 10) of the tile's halo), zeros past the input's
// interior + border and in channels C..kp-1, HALO_U 16-byte chunks a thread
// of the warpgroup: global -> registers (fetch_block), registers -> the
// block's swizzled 128-byte pixel rows in shared memory (put_block).
constexpr int HALO_U = (WG_PIX * KB / 8 + 127) / 128;  // 7

__device__ __forceinline__ void fetch_block(const Params& p, int tile, int kb,
                                            int g, int wtid,
                                            uint4 (&v)[HALO_U]) {
  const int tj = tile % p.n_col_tiles, rest = tile / p.n_col_tiles;
  const int ti = rest % p.n_row_tiles, b = rest / p.n_row_tiles;
  const bf16* xb = p.x + (size_t)b * p.hp * p.wp * p.c;
  const int r0 = ti * TH, c0 = p.padw - 1 + tj * TW + g * (TW / 2);
  const int col_end = p.padw + p.w_out + 1;  // last column read + 1
#pragma unroll
  for (int u = 0; u < HALO_U; ++u) {
    const int idx = u * 128 + wtid, pix = idx >> 3;
    const int ch = kb * (KB / 8) + (idx & 7);
    const int hr = pix / WG_W, hc = pix - hr * WG_W;
    const int pr = r0 + hr, pc = c0 + hc;
    v[u] = make_uint4(0, 0, 0, 0);
    if (idx < WG_PIX * 8 && pr < p.hp && pc < col_end && ch * 8 < p.c)
      ld_global_v4(v[u], xb + ((size_t)pr * p.wp + pc) * p.c + ch * 8);
  }
}

__device__ __forceinline__ void put_block(unsigned char* block, int wtid,
                                          const uint4 (&v)[HALO_U]) {
#pragma unroll
  for (int u = 0; u < HALO_U; ++u) {
    const int idx = u * 128 + wtid;
    if (idx < WG_PIX * 8)
      *reinterpret_cast<uint4*>(block + swizzle128(idx * 16)) = v[u];
  }
}

// Zero the pixels [r0, r1) x [c0, c1) of image yb, channels [n0, n1).
__device__ void zero_rect(const Params& p, bf16* yb, int r0, int r1, int c0,
                          int c1, int n0, int n1, int tid) {
  const int chunks = (n1 - n0) / 8, cols = c1 - c0;
  const int n = (r1 - r0) * cols * chunks;
  for (int idx = tid; idx < n; idx += CONSUMERS) {
    const int pix = idx / chunks, ch = idx - pix * chunks;
    const int r = r0 + pix / cols, c = c0 + pix % cols;
    *reinterpret_cast<uint4*>(yb + ((size_t)r * p.wp + c) * p.c2 + n0 +
                              ch * 8) = make_uint4(0, 0, 0, 0);
  }
}

// The border pixels of y that tile (ti, tj) owns: the top/bottom row
// across its columns (the corner tiles out to the edge), the padw side
// columns beside its rows; channels [n0, n1) of the slice.
__device__ void zero_borders(const Params& p, bf16* yb, int ti, int tj,
                             int n0, int n1, int tid) {
  const int j0 = tj * TW, i0 = ti * TH;
  const int cl = tj == 0 ? 0 : p.padw + j0;
  const int cr = tj == p.n_col_tiles - 1 ? p.wp : p.padw + j0 + TW;
  if (ti == 0) zero_rect(p, yb, 0, 1, cl, cr, n0, n1, tid);
  if (ti == p.n_row_tiles - 1) zero_rect(p, yb, p.hp - 1, p.hp, cl, cr, n0, n1, tid);
  const int rb = 1 + i0, re = 1 + min(i0 + TH, p.h);
  if (tj == 0) zero_rect(p, yb, rb, re, 0, p.padw, n0, n1, tid);
  if (tj == p.n_col_tiles - 1)
    zero_rect(p, yb, rb, re, p.padw + p.w_out, p.wp, n0, n1, tid);
}

// ------------------------------------------------------------------ K loop
// The 4 wgmmas of tap TAP of halo block kb: A at `block` (this warpgroup's
// 64 pixels of the block, halo rows PITCH pixels long), one commit group.
template <int NS, int PITCH, int TAP>
__device__ __forceinline__ void tap_mma(const Params& p, uint32_t sbase,
                                        uint32_t block, int kb, float* acc) {
  constexpr int ky = TAP / 3, kx = TAP % 3;
  const uint32_t a0 = block + (ky * PITCH + kx) * 128;
  const uint32_t w0 = sbase + (TAP * p.kp + kb * KB) * NS * 2;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma_ss<NS>(acc, a_desc<PITCH>(a0 + s * 32),
                 b_desc<NS>(w0 + s * 16 * NS * 2), (kb | TAP | s) != 0);
  wgmma_commit();
}

// acc = warpgroup g's 64 x NS block of the tile (f32), once the caller
// waits for the last groups (and, async, hands back the last stage).
// Async: block kb's stage is waited for before its first tap; the stage
// of block kb - 1 goes back once block kb's first group is the only one
// pending (q0: the blocks this CTA consumed before the tile).
// 9-tap: at the start of block kb the warpgroup stores the block's halo
// from registers (v) to shared memory, syncs its own 128 threads, and
// sends out the loads of the block after it (this tile's next, else
// block 0 of tile `next`) to land while the block computes. On its first
// tile, warpgroup 0 lets warpgroup 1 start when it reaches block 1 (or
// ends the tile).
template <int NS, bool ASYNC>
__device__ __forceinline__ void tile_mma(const Params& p, unsigned char* smem,
                                         int tid, uint32_t q0, int tile,
                                         int next, bool first,
                                         uint4 (&v)[HALO_U], float* acc) {
  constexpr int PITCH = ASYNC ? HALO_W : WG_W;
  const uint32_t sbase = smem_u32(smem);
  const int nkb = p.kp / KB, g = tid / 128;
  for (int kb = 0; kb < nkb; ++kb) {
    const uint32_t n = q0 + kb;
    uint32_t block;
    if constexpr (ASYNC) {
      const uint32_t st = n % STAGES;
      mbar_wait(sbase + p.bar_off + st * 8, (n / STAGES) & 1);
      block = sbase + p.halo_off + st * STAGE_BYTES + g * (TW / 2) * 128;
    } else {
      if (first && kb == 1 && g == 0) stagger_arrive();
      unsigned char* b = smem + p.halo_off + (g * nkb + kb) * WG_BLOCK_BYTES;
      put_block(b, tid % 128, v);
      fence_proxy_async();  // the stores -> the wgmmas' reads
      wg_sync(g);
      if (kb + 1 < nkb)
        fetch_block(p, tile, kb + 1, g, tid % 128, v);
      else if (next >= 0)
        fetch_block(p, next, 0, g, tid % 128, v);
      block = smem_u32(b);
    }
    tap_mma<NS, PITCH, 0>(p, sbase, block, kb, acc);
    if (ASYNC && kb > 0) {
      wgmma_wait<1>();
      mbar_arrive(sbase + p.bar_off + (STAGES + (n - 1) % STAGES) * 8);
    }
    tap_mma<NS, PITCH, 1>(p, sbase, block, kb, acc);
    tap_mma<NS, PITCH, 2>(p, sbase, block, kb, acc);
    tap_mma<NS, PITCH, 3>(p, sbase, block, kb, acc);
    tap_mma<NS, PITCH, 4>(p, sbase, block, kb, acc);
    tap_mma<NS, PITCH, 5>(p, sbase, block, kb, acc);
    tap_mma<NS, PITCH, 6>(p, sbase, block, kb, acc);
    tap_mma<NS, PITCH, 7>(p, sbase, block, kb, acc);
    tap_mma<NS, PITCH, 8>(p, sbase, block, kb, acc);
  }
}

// This warp's 16 pixels, (i0 + r / 8, j0 + r % 8) for r < 16, x the
// slice's NS channels: f32 -> bf16 once into the staging tile `stg`
// (16-byte chunk c of pixel r at c ^ (r % CH)), then 16-byte stores of
// whole 8-channel runs.
template <int NS>
__device__ __forceinline__ void store_tile(const Params& p, const float* acc,
                                           unsigned char* stg, bf16* yb,
                                           int i0, int j0, int nb, int lane) {
  constexpr int CH = NS / 8;
  const int r = lane >> 2, off = (lane & 3) * 4;
#pragma unroll
  for (int t = 0; t < CH; ++t) {
    const int chunk = (t ^ (r & (CH - 1))) * 16;
    *reinterpret_cast<__nv_bfloat162*>(stg + r * NS * 2 + chunk + off) =
        __floats2bfloat162_rn(acc[4 * t], acc[4 * t + 1]);
    *reinterpret_cast<__nv_bfloat162*>(stg + (r + 8) * NS * 2 + chunk + off) =
        __floats2bfloat162_rn(acc[4 * t + 2], acc[4 * t + 3]);
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 16 * CH / 32; ++k) {
    const int q = lane + 32 * k, px = q / CH, c8 = q % CH;
    const int i = i0 + (px >> 3), j = j0 + (px & 7), n = nb + c8 * 8;
    if (i < p.h && j < p.w_out && n < p.c2)
      *reinterpret_cast<uint4*>(
          yb + ((size_t)(1 + i) * p.wp + p.padw + j) * p.c2 + n) =
          *reinterpret_cast<const uint4*>(stg + px * NS * 2 +
                                          (c8 ^ (px & (CH - 1))) * 16);
  }
  __syncwarp();  // the staging tile is rewritten by the next tile
}

// ------------------------------------------------------------------ kernel
// The consumers' walk: (M tile, slice) items it, it + grid, ... of this CTA.
template <int NS, bool ASYNC>
__device__ __forceinline__ void consume(const Params& p, unsigned char* smem,
                                        int tid) {
  const uint32_t sbase = smem_u32(smem);
  const int warp = tid / 32, lane = tid % 32, g = warp / 4;
  const int n_items = p.n_tiles * p.n_slices, nkb = p.kp / KB;
  float acc[NS / 2];
  int loaded = -1;
  uint32_t q0 = 0;  // halo blocks consumed (the ring's position)
  unsigned char* stg = smem + p.stg_off + warp * 16 * NS * 2;
  uint4 v[HALO_U];  // 9-tap: the next halo block, in flight
  if (!ASYNC && blockIdx.x < n_items)
    fetch_block(p, blockIdx.x / p.n_slices, 0, g, tid % 128, v);
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int slice = it % p.n_slices, tile = it / p.n_slices;
    const int tj = tile % p.n_col_tiles, rest = tile / p.n_col_tiles;
    const int ti = rest % p.n_row_tiles, b = rest / p.n_row_tiles;
    const int nb = slice * NS;
    bf16* yb = p.y + (size_t)b * p.hp * p.wp * p.c2;
    if (slice != loaded) {  // once a launch with the default grid
      consumer_sync();      // no warp still reads the previous slice
      load_weights<NS>(p, smem, nb, tid);
      fence_proxy_async();
      consumer_sync();
      loaded = slice;
    }
    zero_borders(p, yb, ti, tj, nb, min(nb + NS, p.c2), tid);
    const int next = it + (int)gridDim.x < n_items
                         ? (it + (int)gridDim.x) / p.n_slices : -1;
    const bool first = it == (int)blockIdx.x;
    if (!ASYNC && first && g == 1) stagger_wait();
    tile_mma<NS, ASYNC>(p, smem, tid, q0, tile, next, first, v, acc);
    if (!ASYNC && first && g == 0 && nkb == 1) stagger_arrive();
    wgmma_wait<0>();
    fence_operands<NS / 2>(acc);
    if (ASYNC)  // the tile's last stage
      mbar_arrive(sbase + p.bar_off + (STAGES + (q0 + nkb - 1) % STAGES) * 8);
    store_tile<NS>(p, acc, stg, yb, ti * TH + 2 * (warp % 4), tj * TW + 8 * g,
                   nb, lane);
    q0 += nkb;
  }
}

// The async kernel's producer: one thread issues the TMA loads of every
// (M tile, 64-channel block) of the walk into the ring.
__device__ __forceinline__ void produce(const Params& p, uint32_t sbase,
                                        const CUtensorMap* tmap) {
  uint32_t n = 0;
  for (int it = blockIdx.x; it < p.n_tiles * p.n_slices; it += gridDim.x) {
    const int tile = it / p.n_slices;
    const int tj = tile % p.n_col_tiles, rest = tile / p.n_col_tiles;
    const int ti = rest % p.n_row_tiles, b = rest / p.n_row_tiles;
    for (int kb = 0; kb < p.kp / KB; ++kb, ++n) {
      const uint32_t st = n % STAGES;
      const uint32_t full = sbase + p.bar_off + st * 8;
      // a fresh barrier passes the wait for parity 1 at once
      mbar_wait(full + STAGES * 8, ((n / STAGES) & 1) ^ 1);
      mbar_arrive_tx(full, STAGE_TX);
      tma_load_4d(sbase + p.halo_off + st * STAGE_BYTES, tmap, full,
                  kb * KB, p.padw - 1 + tj * TW, ti * TH, b);
    }
  }
}

// grid: the persistent CTAs; block: two consumer warpgroups (+ a producer
// warpgroup in the async kernel, whose registers go to the consumers)
template <int NS, bool ASYNC>
__global__ void __launch_bounds__(ASYNC ? CONSUMERS + 128 : CONSUMERS, 1)
    conv3x3_kernel(const Params p, const __grid_constant__ CUtensorMap tmap) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + ALIGN - 1) &
      ~uintptr_t(ALIGN - 1));
  const int tid = threadIdx.x;
  if constexpr (ASYNC) {
    const uint32_t sbase = smem_u32(smem);
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(sbase + p.bar_off + s * 8, 1);                     // full
        mbar_init(sbase + p.bar_off + (STAGES + s) * 8, CONSUMERS);  // empty
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid >= CONSUMERS) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
      if (tid == CONSUMERS) produce(p, sbase, &tmap);
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
      consume<NS, true>(p, smem, tid);
    }
  } else {
    consume<NS, false>(p, smem, tid);
  }
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

template <int NS, bool ASYNC>
int launch_ns(const Params& p, const CUtensorMap& map, int ctas, int smem,
              cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel<NS, ASYNC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv3x3_kernel<NS, ASYNC>
      <<<ctas, ASYNC ? CONSUMERS + 128 : CONSUMERS, smem, stream>>>(p, map);
  return static_cast<int>(cudaGetLastError());
}

template <bool ASYNC>
int launch(const void* x, const void* w, void* y, int64_t b, int64_t hp,
           int64_t wp, int64_t c, int64_t c2, int64_t padw, int64_t ns,
           int64_t ctas, void* stream) {
  const int64_t h = hp - 2, w_out = wp - 2 * padw;
  if (b < 1 || h < 1 || w_out < 1 || padw < 1 || c < 16 || c2 < 16 ||
      c % 16 || c2 % 16 || b * hp * wp * (c > c2 ? c : c2) >= (int64_t(1) << 31) ||
      (ns != 16 && ns != 32 && ns != 64) || ctas < 1 || ctas > (1 << 20) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(y)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = smem_layout((int)c, (int)ns, ASYNC);
  if (l.total > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.w = static_cast<const bf16*>(w);
  p.y = static_cast<bf16*>(y);
  p.h = (int)h;
  p.w_out = (int)w_out;
  p.c = (int)c;
  p.c2 = (int)c2;
  p.kp = (int)((c + KB - 1) / KB * KB);
  p.padw = (int)padw;
  p.hp = (int)hp;
  p.wp = (int)wp;
  p.n_row_tiles = (int)((h + TH - 1) / TH);
  p.n_col_tiles = (int)((w_out + TW - 1) / TW);
  p.n_tiles = (int)b * p.n_row_tiles * p.n_col_tiles;
  p.n_slices = (int)((c2 + ns - 1) / ns);
  p.halo_off = l.halo_off;
  p.stg_off = l.stg_off;
  p.bar_off = l.bar_off;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (ASYNC) {
    PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)wp, (cuuint64_t)hp,
                                (cuuint64_t)b};
    const cuuint64_t strides[3] = {(cuuint64_t)(c * 2),
                                   (cuuint64_t)(wp * c * 2),
                                   (cuuint64_t)(hp * wp * c * 2)};
    const cuuint32_t box[4] = {KB, HALO_W, HALO_H, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    // out-of-bounds elements of a box arrive as zeros
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
               const_cast<void*>(x), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ns == 64) return launch_ns<64, ASYNC>(p, map, (int)ctas, l.total, s);
  if (ns == 32) return launch_ns<32, ASYNC>(p, map, (int)ctas, l.total, s);
  return launch_ns<16, ASYNC>(p, map, (int)ctas, l.total, s);
}

}  // namespace

// x (B, hp, wp, C), w (9, C, C2), y (B, hp, wp, C2): contiguous bf16,
// 16-byte aligned; C and C2 multiples of 16. ns: the slice width (16, 32
// or 64), ctas: the persistent grid, both from the wrapper's plan
// (ops/cuda_kernels.py:conv3x3_plan). Each returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a shape or
// plan the kernel does not take (one whose shared memory does not fit).
extern "C" int conv3x3_9tap(const void* x, const void* w, void* y,
                            int64_t b, int64_t hp, int64_t wp, int64_t c,
                            int64_t c2, int64_t ns, int64_t ctas,
                            void* stream) {
  return launch<false>(x, w, y, b, hp, wp, c, c2, 1, ns, ctas, stream);
}

extern "C" int conv3x3_async_halo(const void* x, const void* w, void* y,
                                  int64_t b, int64_t hp, int64_t wp,
                                  int64_t c, int64_t c2, int64_t padw,
                                  int64_t ns, int64_t ctas, void* stream) {
  return launch<true>(x, w, y, b, hp, wp, c, c2, padw, ns, ctas, stream);
}
