// Int8 serving stem kernels for Hopper (sm_90a), with a plain C interface
// (loaded through ctypes by automoe_tpu_torch/ops/stem.py; no PyTorch
// headers, so the build takes seconds).
//
// K3  automoe_stem_s2d_pool_int8 replaces automoe_tpu/ops/pallas_stem.py:103
//     _stem_kernel (launched by s2d_stem_pool_int8). It computes, for all
//     experts' stems at once,
//       out = maxpool3x3s2_SAME( clip(rint((conv4x4(xs, w) + bias)^+ * inv), ±127) )
//     over the 2x2 space-to-depth image xs [B,Hc+4,Wc+4,12] (bf16), with w
//     the [192,O] bf16 matrix of the rewritten 4x4/s1 kernel (row
//     (a*4+b)*12+c), bias and inv [O] f32, out [B,Ho,Wo,O] int8.
//     Bound: at 256x256 input (Hc = Wc = 128, O = 256) it does 1.61 GFLOP
//     of bf16 products per image against 1.47 MB of compulsory traffic, so
//     the tensor cores bound it: 0.0130 ms at B=8 and 0.2085 ms at B=128
//     at the H100's 989 TFLOP/s (the bytes alone: 0.0035 / 0.056 ms).
//     What it keeps out of device memory is the pre-pool [B,Hc,Wc,O]
//     tensor and any im2col matrix.
//
//     Design (one kernel, no other launch per call):
//     - Persistent grid: one 256-thread block (two warpgroups) per SM,
//       each walking the (image, 8x8 pooled tile) work items in the stride
//       order item = blockIdx.x + i * gridDim.x, so every tile is done
//       exactly once whatever the count. O > 256 splits into groups of 256
//       channels along gridDim.y, each block keeping one group.
//     - Resident weights: each block writes w[:, group] (192 x 256 bf16,
//       96 KB) into shared memory once, transposed in registers into the
//       K-major 128-byte-swizzled layout that wgmma reads B from.
//     - One staged patch per tile for all channels: an 8x8 pooled tile
//       needs (2*8+1)^2 = 17x17 = 289 conv positions and an input patch of
//       (17+3) x (17+3) x 12 bf16 = 9,600 bytes, copied with 8-byte
//       cp.async (a 12-channel pixel is 24 bytes, so 16-byte copies would
//       need an even first pixel in an even-width image). Implicit GEMM:
//       the A row of conv position (r,c) for tap row a is the 48 contiguous
//       values patch[r+a][c..c+3][0..12), so k = a*48 + b*12 + ch is w's
//       row order and each k16 slice is read straight from the patch with
//       ldmatrix.x4 (K = 192, nothing padded; no im2col anywhere).
//       ldmatrix needs 16-byte aligned rows and pixel p starts at byte 24p,
//       so the patch is kept twice: as is (even p) and 8 bytes earlier
//       (odd p), the second copy 48 bytes off in the 128-byte bank cycle so
//       that the 8 rows of one 8x8 matrix hit distinct banks.
//     - Double buffering: tile t+1's patch is copied (cp.async groups)
//       while tile t runs its products, epilogue and pool.
//     - Tensor cores: wgmma.m64n128k16 bf16 -> f32, A from registers, B
//       from the resident weights. Warpgroup w owns channels 128w..+128
//       and runs the 289 positions as 5 row blocks of 64 (320 rows); 12
//       wgmma per block. A warp stays in its wgmma issue until the products
//       have read its A registers, so the two warpgroups take turns on the
//       tensor cores (named barriers): one quantizes and pools block j
//       while the other's products for block j run.
//     - Epilogue, per conv position in registers: y = s + bias, then
//       clip(rint(relu(y) * |inv|), 127) in three FP32 operations (see
//       epilogue), as bytes into a shared C tile (289 x 256).
//     - Sign of inv: the JAX kernel pools the f32 values, then quantizes,
//       q(max h * inv). Quantizing first and pooling the bytes gives the
//       same for inv >= 0 (q is monotone); for inv < 0 the kernel pools
//       q(h * |inv|) and negates the pooled byte: round half to even and
//       the clip are odd-symmetric, so -max q(h |inv|) = q(max h * inv).
//       A 256-bit map of the negative channels, made once per block,
//       selects the bytes to negate at the store (__vsub4(x ^ m, m)).
//     - Pool: after each row block, the pooled rows whose three conv rows
//       are all in C are reduced with max.u16x2 (two bytes per 16-bit
//       lane, see pool_rows), 16 channels per thread, 16-byte stores.
//       Conv positions outside [0,Hc)x[0,Wc) are excluded (their taps
//       repeat an in-window one), not zero-filled.
//     - Shared memory: weights 98,304 + C 320 x 272 = 87,040 + two patch
//       buffers of 19,328 (both copies) + 128 for the sign map + 1,024 of
//       alignment slack = 225,152 bytes of the 232,448 a block may use. cudaFuncSetAttribute and the SM count are taken once per
//       process and device.
//     Tile choice: at B=8 there are 8 * 4096 / A items for a pooled tile
//     of area A, and at least 4 per SM (528) needs A <= 62. A tile's conv
//     positions over its own are (1 + 1/(2 TP_H)) (1 + 1/(2 TP_W)), at
//     least 1.195 for A = 32 (4x8), 1.129 for 8x8; and wgmma pads M to 64
//     rows: 4x8 gives 153 -> 192 rows (1.50x), 8x8 289 -> 320 (1.25x),
//     8x16 561 -> 576 (1.125x, 256 items at B=8). So "<= 1.15x" and ">= 528
//     items" cannot both hold here; 8x8 costs 1.25x and leaves 512 items at
//     B=8 (3.88 per SM: 4 rounds, 97% balance) and 8,192 at B=128.
//     Not yet: A from shared memory (wgmma's own A descriptor cannot
//     describe 24-byte pixel rows), TMA for the patch, a halo shared
//     between neighbouring tiles, and overlap of the pool's shared-memory
//     reads with the other warpgroup's B reads (both compete for the
//     SM's 128 bytes per clock).
//
// K3 at float32, automoe_stem_s2d_pool_int8_f32 replaces the same TPU
//     kernel (pallas_stem.py:103) in the instantiation it takes for an f32
//     input (pallas_stem.py:231 casts w to xs's dtype, :254 sizes the patch
//     buffer in it): the same function for an f32 xs [B,Hc+4,Wc+4,12] and
//     w [192,O] (O % 64 == 0). The int8 engine at f32 (`automoe-serve-torch
//     --quantize --fp32`) and the eval CLI's `gating --quantize` run it.
//     Three TF32 passes: each f32 value v is split as hi = rna(v), lo =
//     rna(v - hi) (cvt.rna.tf32.f32, round to nearest, ties away; the
//     tensor cores would truncate an unsplit value), and hi*hi + hi*lo +
//     lo*hi accumulate in f32 on the tensor cores. lo*lo and lo's own
//     rounding are below f32's 2^-24. Share of int8 outputs off by one
//     against a float64 conv, K3's inputs at the tests' statistics (an
//     emulation in PyTorch on the CPU, 4 images of 132x132x12, O = 256):
//       plain f32 7.2e-6 | one TF32 pass 7.8e-3 | three passes 8.8e-6 |
//       bf16 split, 3 products 1.1e-4 | bf16 split, 6 products 3.3e-6
//     One pass misses the port's tolerance (±1 on at most 1e-3 of the
//     elements), and the bf16 split in 3 products is 12x less exact than
//     f32, so three TF32 passes. Bound: 3 passes x 2*B*Hc*Wc*192*O over
//     the 495 TFLOP/s of dense TF32, 0.078 ms at B=8 and 0.312 ms at B=32
//     (256x256 input, O = 256); the bytes (1.9 MB an image) take 0.018 ms
//     at B=32.
//     Design, on K3's (the bf16 kernel's) frame:
//     - Persistent grid of 256-thread blocks (two warpgroups), one block
//       per SM, gridDim.y over 64-channel groups (O = 256: four), each
//       block walking the (image, 8x8 pooled tile) items of its group.
//     - Resident split weights: w_hi and w_lo of the group (2 x 48 KB),
//       written once per block, K-major in the 128-byte swizzle (a row of
//       32 floats is one atom; K = 192 is six atom columns).
//     - The 20x20x12 f32 patch (19,200 bytes) double-buffered with 16-byte
//       cp.async (a 48-byte pixel keeps every row 16-byte aligned, so one
//       copy serves ldmatrix).
//     - Tensor cores: wgmma.m64n64k8.f32.tf32.tf32, A from registers, B
//       from the resident weights; per 64-row block 24 k8 slices x 3
//       passes = 72 products. A is read with ldmatrix.x4 on the b16 view
//       (row lane/4, word lane%4: the TF32 fragment) and split in
//       registers, one tap row (6 slices) a commit group, two register
//       sets in turn (the products read their A registers until they
//       complete; wait_group 1 frees the older set). The tile's 5 row
//       blocks go to the warpgroups in turn across tiles (block j of the
//       block's it-th tile to warpgroup (it + j) & 1), the turns handed
//       over through named barriers: one warpgroup's epilogue and next A
//       split run while the other's products do.
//     - Accuracy of the sum: the tensor cores truncate each sum they
//       accumulate, an error of the accumulator's size. 72 products into
//       one accumulator put 5.7e-5 of the int8 outputs off by one against
//       the plain version (f32 conv) at B=32, five times f32's level. So
//       each commit group gets a fresh accumulator that the warp adds into
//       an f32 sum (FADD, round to nearest) once wait_group has seen the
//       group done, and within a group the small products (lo*hi, hi*lo)
//       go first, truncated while the accumulator is still 2^-11 of its
//       final size: 1.0e-5 off, f32's level (FFMA on the CUDA cores:
//       1.1e-5; tools/bench_stem.py --dtype f32 on an H100).
//     - Epilogue: bias + ReLU in f32 into a shared f32 C tile (289 x 72
//       floats); after the tile, the 3x3/s2 max over in-window positions
//       (taps outside [0,Hc)x[0,Wc) clamp onto the window's edge, which
//       repeats a value), then clip(rint(max * inv), ±127): the plain
//       version's order, for any sign of inv.
//     - Shared memory: 98,304 weights + 38,400 patches + 83,232 C + 1,024
//       alignment slack = 220,960 bytes.
//     Not yet: TMA for the patch, a halo shared between neighbouring
//     tiles, and the pool overlapped with the products (the tensor cores
//     wait on it; K3 bf16 pools rows as their conv rows land, and a
//     second C tile does not fit). At 254 registers a thread, a third A
//     set or a deeper queue of products would spill.
//
// K4  automoe_maxpool3x3s2_int8 replaces automoe_tpu/ops/pallas_stem.py
//     _pool_kernel (launched by maxpool3x3s2_int8): 3x3/s2 SAME max-pool
//     of an int8 NHWC tensor (out-of-range taps skipped, which is the
//     reduce_window -128 pad). Memory-bound (5.2 MB per 128x128x256
//     image in and out); one thread per (pixel, 16 channels) with 16-byte
//     loads and per-byte __vmaxs4.
//
// Every launching entry point launches on the given stream, allocates
// nothing and returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// cp.async: global -> shared without a register round trip. With
// src_bytes 0 the 8 destination bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of d across the async products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64x128] (+)= A[64x16] (registers, the mma.m16n8k16 A layout per warp)
// * B[16x128] (shared memory, through the descriptor); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

constexpr int CIN = 12;                      // s2d channels
constexpr int KDIM = 16 * CIN;               // 4x4 taps x 12 = 192
constexpr int K_STEPS = KDIM / 16;           // 12 k16 slices: tap row a, third j
constexpr int TP_H = 8;                      // pooled rows per tile
constexpr int TP_W = 8;                      // pooled cols per tile
constexpr int TC_H = 2 * TP_H + 1;           // conv rows per tile (17)
constexpr int TC_W = 2 * TP_W + 1;           // conv cols per tile (17)
constexpr int M_VALID = TC_H * TC_W;         // 289 conv positions
constexpr int M_BLOCKS = (M_VALID + 63) / 64;  // 5 wgmma row blocks (320 rows)
constexpr int PH = TC_H + 3;                 // patch rows (20)
constexpr int PW = TC_W + 3;                 // patch cols (20)
constexpr int ROW_CHUNKS = PW * CIN / 4;     // 8-byte copies per patch row (60)
constexpr int CHUNKS = PH * ROW_CHUNKS;      // 1,200
constexpr int PATCH_BYTES = CHUNKS * 8;      // 9,600
constexpr int OG = 256;                      // output channels per block
constexpr int NH = OG / 2;                   // channels per warpgroup (128)
constexpr int THREADS = 256;                 // two warpgroups
constexpr int LDC = OG + 16;                 // byte row pitch of the int8 C tile
// weights, K-major with the 128-byte swizzle: per 64-k atom column, 32
// groups of 8 channels x 128 bytes (64 k), 16-byte chunk c of row n at
// chunk c ^ n; groups 1,024 bytes apart (SBO), atom columns 32 KB apart
constexpr int W_GROUP = 1024, W_KATOM = OG / 8 * W_GROUP;          // 32,768
// patch buffer: copy 0 at +0, copy 1 (shifted 8 bytes earlier) based at
// Q1 = PATCH_BYTES + 48, i.e. 48 bytes off copy 0 in the 128-byte cycle
constexpr int Q1 = PATCH_BYTES + 48;
constexpr int BUF_BYTES = (Q1 + PATCH_BYTES - 8 + 127) / 128 * 128;  // 19,328
constexpr int W_OFF = 0;
constexpr int C_OFF = W_OFF + K_STEPS / 4 * W_KATOM;                // 98,304
constexpr int P_OFF = C_OFF + M_BLOCKS * 64 * LDC;                  // 185,344
constexpr int S_OFF = P_OFF + 2 * BUF_BYTES;                        // 224,000: inv's sign map
constexpr int STEM_SMEM = S_OFF + 128 + 1024;  // 225,152 with the alignment slack
static_assert(PATCH_BYTES % 128 == 0 && C_OFF % 128 == 0 && P_OFF % 128 == 0,
              "shared regions must stay 128-byte aligned");
static_assert(STEM_SMEM <= 232448, "over the 227 KB a block may use");

// Copy the patch of xs rows r0..r0+PH, cols c0..c0+PW of one image into
// both copies of a buffer, zero-filled outside the image.
__device__ __forceinline__ void stage_patch(unsigned char* buf,
                                            const __nv_bfloat16* __restrict__ xb,
                                            int r0, int c0, int Hp, int Wp) {
  for (int i = threadIdx.x; i < CHUNKS; i += THREADS) {
    const int pr = i / ROW_CHUNKS, k = i % ROW_CHUNKS;
    const int R = r0 + pr, C = c0 + k / 3;
    const bool ok = R >= 0 && R < Hp && C >= 0 && C < Wp;
    const __nv_bfloat16* src = ok ? xb + ((size_t)R * Wp + C) * CIN + (k % 3) * 4 : xb;
    cp_async8(buf + 8 * i, src, ok ? 8 : 0);
    cp_async8(buf + Q1 + 8 * (i - 1), src, ok ? 8 : 0);
  }
}

// Byte offset (within a patch buffer) of the ldmatrix row that this lane
// supplies for m16 row tile mt at k slice 0; slice (a, j) adds
// a*PW*24 + 32*j. Padding rows read position 0 and are never stored.
__device__ __forceinline__ int a_row_offset(int mt, int lane) {
  int m = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  if (m >= M_VALID) m = 0;
  const int p = (m / TC_W) * PW + m % TC_W;  // patch pixel of the position
  return ((p & 1) ? Q1 + 24 * p - 8 : 24 * p) + 16 * (lane >> 4);
}

// A fragments of all 12 k slices of one 64-row block (this warp's 16 rows)
__device__ __forceinline__ void load_a(uint32_t (&a)[K_STEPS][4], unsigned row) {
#pragma unroll
  for (int kk = 0; kk < K_STEPS; ++kk)
    ldmatrix_x4(a[kk], row + (kk / 3) * PW * CIN * 2 + (kk % 3) * 32);
}

__device__ __forceinline__ void issue_block(float (&d)[64], const uint32_t (&a)[K_STEPS][4],
                                            uint64_t desc) {
  fence_acc(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K_STEPS; ++kk)
    wgmma_m64n128k16(d, a[kk], desc + (uint64_t)(((kk / 4) * W_KATOM + (kk % 4) * 32) >> 4),
                     kk);
  wgmma_commit();
}

// C keeps the channels of each 16-channel group in the order the
// accumulators hold them: channel 8h + 2t + e at byte 4t + 2h + e, so a
// thread stores the 4 bytes of channels 2t, 2t+1, 8+2t, 9+2t at once (the
// pool restores the order). v[u][k] holds a value's bits in its low byte:
// u = column tile i0 + u, k = 2 * (row half) + (channel parity).
__device__ __forceinline__ void store_c(unsigned char* row, int i0, const uint32_t (&v)[4][4]) {
#pragma unroll
  for (int u = 0; u < 4; u += 2)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(row + 8 * hr * LDC + 8 * (i0 + u)) =
          __byte_perm(__byte_perm(v[u][2 * hr], v[u][2 * hr + 1], 0x0040),
                      __byte_perm(v[u + 1][2 * hr], v[u + 1][2 * hr + 1], 0x0040), 0x5410);
}

// Bias, ReLU, rint(v * |inv|) clipped to 127 per conv position, as bytes
// into C, in three FP32 operations: y = s + bias; u = sat(y * |inv| / 128),
// which is clamp(relu(y) * |inv|, 0, 128) / 128 exactly (a power-of-two scale does not
// change the rounding); then u * 128 + 1.5 * 2^23 rounds it half to even
// (as rintf, torch.round and jnp.round do) and leaves the integer (0..128;
// the pool clips 128 to 127) in the low byte of the sum's bits. Thread
// (g, t) of warp wq holds rows 16 wq + g (+8) of the block and channels
// 8i + 2t (+1) of its warpgroup's 128; qr[i] holds (bias, |inv| / 128) of
// channels 8i + 2t and 8i + 2t + 1. Rows past M_VALID land in C's padding.
__device__ __forceinline__ float mul_sat(float a, float b) {
  float r;
  asm("mul.rn.sat.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void epilogue(float (&d)[64], unsigned char* Cs,
                                         const float4 (&qr)[16], int mblock, int wq, int lane,
                                         int c0) {
  fence_acc(d);
  const int g = lane >> 2, t = lane & 3;
  unsigned char* row = Cs + (mblock * 64 + wq * 16 + g) * LDC + c0 + 4 * t;
#pragma unroll
  for (int i0 = 0; i0 < 16; i0 += 4) {
    const float4* qp = qr + i0;
    uint32_t v[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float b = (k & 1) ? qp[u].z : qp[u].x, iv = (k & 1) ? qp[u].w : qp[u].y;
        v[u][k] = __float_as_uint(
            __fmaf_rn(mul_sat(__fadd_rn(d[4 * (i0 + u) + k], b), iv), 128.0f, 12582912.0f));
      }
    store_c(row, i0, v);
  }
}

// max of unsigned 16-bit lanes (a native instruction on sm_90). Its high
// byte is the max of the lanes' high bytes whatever the low bytes hold.
__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// C's byte order within a 16-channel group (see store_c) back to channels
__device__ __forceinline__ uint4 unpermute(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3) {
  return make_uint4(__byte_perm(w0, w1, 0x5410), __byte_perm(w2, w3, 0x5410),
                    __byte_perm(w0, w1, 0x7632), __byte_perm(w2, w3, 0x7632));
}

// First pooled row of the tile whose 3 conv rows are not all in C after
// row block j (j = 5: one past the last).
__host__ __device__ constexpr int pool_first(int j) {
  return (((j * 64 < M_VALID ? j * 64 : M_VALID) / TC_W) - 1) / 2;
}
static_assert(pool_first(0) == 0 && pool_first(M_BLOCKS) == TP_H, "pool rows must tile");

// 3x3/s2 max over the quantized positions of pooled rows [pr0, pr1) of the
// tile, 16 of the warpgroup's channels per thread. C's bytes are 0..128:
// the odd bytes are the high bytes of the raw words' 16-bit lanes and the
// even ones those of the words shifted by 8, so max.u16x2 reduces both;
// then 128 becomes 127. A tap outside
// [0,Hc)x[0,Wc) is clamped onto the window's edge, which is inside the
// window too (and inside the tile's C rows even where p >= Ho), so it
// repeats a value instead of adding one. A thread's 16 channels are the
// same in every iteration; the bytes of those whose inv is negative are
// negated at the store (sgn: the block's sign map, one bit a channel).
__device__ __forceinline__ void pool_rows(const unsigned char* Cs, const uint32_t* sgn,
                                          int8_t* out_b, int c0, int og, int pr0, int pr1,
                                          int p0, int q0, int Hc, int Wc, int Ho, int Wo, int O,
                                          int t128) {
  uint4 neg;  // 0xFF in the bytes of negative-inv channels
  {
    const int ch = c0 + (t128 % (NH / 16)) * 16;
    const uint32_t bits = sgn[ch >> 5] >> (ch & 31);
    uint32_t m[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)  // bit k of the nibble to byte k
      m[j] = (((bits >> (4 * j)) & 0xFu) * 0x00204081u & 0x01010101u) * 0xFFu;
    neg = make_uint4(m[0], m[1], m[2], m[3]);
  }
  for (int i = t128; i < (pr1 - pr0) * TP_W * (NH / 16); i += 128) {
    const int gi = i % (NH / 16), pl = i / (NH / 16);
    const int p = p0 + pr0 + pl / TP_W, q = q0 + pl % TP_W;
    const int ch = c0 + gi * 16;
    const unsigned char* cb = Cs + ch;
    int rows[3], cols[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rows[k] = (min(max(2 * p - 1 + k, 0), Hc - 1) - (2 * p0 - 1)) * TC_W * LDC;
      cols[k] = (min(max(2 * q - 1 + k, 0), Wc - 1) - (2 * q0 - 1)) * LDC;
    }
    uint32_t ev[4], od[4];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const uint4 v = *reinterpret_cast<const uint4*>(cb + rows[k / 3] + cols[k % 3]);
      const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ev[j] = k ? max_u16x2(ev[j], vw[j] << 8) : vw[j] << 8;
        od[j] = k ? max_u16x2(od[j], vw[j]) : vw[j];
      }
    }
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r[j] = __byte_perm(ev[j], od[j], 0x7351);
      r[j] -= (r[j] >> 7) & 0x01010101u;
    }
    if (p < Ho && q < Wo && ch < og) {
      uint4 o = unpermute(r[0], r[1], r[2], r[3]);
      o = make_uint4(__vsub4(o.x ^ neg.x, neg.x), __vsub4(o.y ^ neg.y, neg.y),
                     __vsub4(o.z ^ neg.z, neg.z), __vsub4(o.w ^ neg.w, neg.w));
      *reinterpret_cast<uint4*>(out_b + ((size_t)p * Wo + q) * O + ch) = o;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
s2d_stem_pool_int8_kernel(const __nv_bfloat16* __restrict__ xs,
                          const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ inv,
                          int8_t* __restrict__ out,
                          int B, int Hp, int Wp, int O, int Ho, int Wo) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzled weights need a 1,024-byte aligned base
  const unsigned raw_addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw_addr & 1023)) & 1023);
  unsigned char* Cs = smem + C_OFF;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup (channel half), warp in it

  const int Hc = Hp - 4, Wc = Wp - 4;
  const int tiles_h = (Ho + TP_H - 1) / TP_H, tiles_w = (Wo + TP_W - 1) / TP_W;
  const int per_image = tiles_h * tiles_w, items = B * per_image;
  const int o0 = blockIdx.y * OG;           // this block's channel group
  const int og = min(OG, O - o0);           // 64, 128, 192 or 256

  auto tile_origin = [&](int item, int& b, int& p0, int& q0) {
    b = item / per_image;
    const int tl = item % per_image;
    p0 = (tl / tiles_w) * TP_H;
    q0 = (tl % tiles_w) * TP_W;
  };
  auto stage = [&](int item, int buf) {
    int b, p0, q0;
    tile_origin(item, b, p0, q0);
    stage_patch(smem + P_OFF + buf * BUF_BYTES, xs + (size_t)b * Hp * Wp * CIN,
                2 * p0 - 1, 2 * q0 - 1, Hp, Wp);
  };

  int item = blockIdx.x;
  stage(item, 0);  // the first patch flies while the weights are set up
  cp_async_commit();
  // weights, once per block: core matrix (kk, n8 group, k half) holds
  // rows n = 8 ng .. +8 of w[16 kk + 8 h .. +8, o0 + n], transposed in
  // registers from 8 16-byte loads; channels past og are zero
  for (int cm = tid; cm < K_STEPS * (OG / 8) * 2; cm += THREADS) {
    const int h = cm & 1, ng = (cm >> 1) % (OG / 8), kk = cm / (OG / 4);
    uint4 v[8], r[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = 8 * ng < og ? *reinterpret_cast<const uint4*>(
                               w + (size_t)(16 * kk + 8 * h + k) * O + o0 + 8 * ng)
                         : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const unsigned sel = (n & 1) ? 0x7632u : 0x5410u;
      uint32_t x[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint4 u = v[k];
        x[k] = (n >> 1) == 0 ? u.x : (n >> 1) == 1 ? u.y : (n >> 1) == 2 ? u.z : u.w;
      }
      r[n] = make_uint4(__byte_perm(x[0], x[1], sel), __byte_perm(x[2], x[3], sel),
                        __byte_perm(x[4], x[5], sel), __byte_perm(x[6], x[7], sel));
    }
    unsigned char* dst = smem + W_OFF + (kk / 4) * W_KATOM + ng * W_GROUP;
    const int chunk = 2 * (kk % 4) + h;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint4*>(dst + n * 128 + ((chunk ^ n) << 4)) = r[n];
  }
  // the weights are read by wgmma (async proxy) after generic stores
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const unsigned w_addr = static_cast<unsigned>(__cvta_generic_to_shared(smem + W_OFF));
  // descriptor: start >> 4, LBO 1 (unused when swizzled), SBO 1024 >> 4,
  // layout 1 = 128-byte swizzle
  const uint64_t desc = (uint64_t)(((w_addr + wg * (NH / 8) * W_GROUP) >> 4) & 0x3FFF) |
                        (1ull << 16) | ((uint64_t)(W_GROUP >> 4) << 32) | (1ull << 62);
  const unsigned p_base = static_cast<unsigned>(__cvta_generic_to_shared(smem + P_OFF));
  const int c0 = wg * NH;  // this warpgroup's first channel in the group
  if (wg == 1) named_arrive(3, 256);  // warpgroup 0 takes the first turn

  // the epilogue's (bias, |inv| / 128) of this thread's 32 channels
  float4 qr[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int ch = c0 + 8 * i + 2 * (lane & 3);
    qr[i] = ch < og ? make_float4(bias[o0 + ch], fabsf(inv[o0 + ch]) * 0.0078125f,
                                  bias[o0 + ch + 1], fabsf(inv[o0 + ch + 1]) * 0.0078125f)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // the sign map: warp w's ballot covers channels 32w..32w+31 of the group
  // (seen by every thread after the tile loop's first barrier)
  uint32_t* sgn = reinterpret_cast<uint32_t*>(smem + S_OFF);
  {
    const unsigned b = __ballot_sync(0xffffffffu, tid < og && inv[o0 + tid] < 0.0f);
    if (lane == 0) sgn[warp] = b;
  }
  for (int it = 0; item < items; item += gridDim.x, ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // this patch landed; every thread is done with the last tile
    int b, p0, q0;
    tile_origin(item, b, p0, q0);
    int8_t* out_b = out + (size_t)b * Ho * Wo * O + o0;

    // 5 row blocks of 64 positions x this warpgroup's 128 channels. The
    // two warpgroups take turns on the tensor cores (named barriers 3 and
    // 4): a warp stays in its wgmma issue until the products have read its
    // A registers, so one warpgroup quantizes and pools block j while the
    // other's products for block j run.
    const unsigned pb = p_base + buf * BUF_BYTES;
#pragma unroll
    for (int j = 0; j < M_BLOCKS; ++j) {
      uint32_t a[K_STEPS][4];
      float acc[64];
      load_a(a, pb + a_row_offset(j * 4 + wq, lane));
      named_sync(3 + wg, 256);
      issue_block(acc, a, desc);
      named_arrive(3 + (wg ^ 1), 256);
      // the next tile's patch flies while this one computes
      if (j == 0 && item + (int)gridDim.x < items) stage(item + gridDim.x, buf ^ 1);
      if (j == 0) cp_async_commit();
      wgmma_wait_all();
      epilogue(acc, Cs, qr, j, wq, lane, c0);
      named_sync(1 + wg, 128);  // this warpgroup's C rows of block j are written
      // pooled rows whose conv rows are now all in C
      pool_rows(Cs, sgn, out_b, c0, og, pool_first(j), pool_first(j + 1), p0, q0, Hc, Wc, Ho,
                Wo, O, tid & 127);
    }
  }
  if (wg == 0) named_sync(3, 256);  // warpgroup 1's last turn hand-over
  cp_async_wait_all();
}

__global__ void maxpool3x3s2_int8_kernel(const int8_t* __restrict__ x,
                                         int8_t* __restrict__ out,
                                         int B, int H, int W, int C,
                                         int Ho, int Wo) {
  const int G = C / 16;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * Ho * Wo * G) return;
  const int g = (int)(i % G);
  long long t = i / G;
  const int q = (int)(t % Wo);
  t /= Wo;
  const int p = (int)(t % Ho);
  const int b = (int)(t / Ho);
  uint4 m = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
  for (int dr = 0; dr < 3; ++dr) {
    const int r = 2 * p - 1 + dr;
    if (r < 0 || r >= H) continue;
    for (int dc = 0; dc < 3; ++dc) {
      const int c = 2 * q - 1 + dc;
      if (c < 0 || c >= W) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(
          x + (((size_t)b * H + r) * W + c) * C + g * 16);
      m.x = __vmaxs4(m.x, v.x);
      m.y = __vmaxs4(m.y, v.y);
      m.z = __vmaxs4(m.z, v.z);
      m.w = __vmaxs4(m.w, v.w);
    }
  }
  *reinterpret_cast<uint4*>(out + (((size_t)b * Ho + p) * Wo + q) * C + g * 16) = m;
}

// ---------------------------------------------------------------------------
// K3 at float32 (automoe_stem_s2d_pool_int8_f32): wgmma TF32, three passes.
// ---------------------------------------------------------------------------

constexpr int F_OG = 64;                          // channels per block
constexpr int F_KSTEPS = KDIM / 8;                // 24 k8 slices
constexpr int F_CHUNK = 6;                        // slices per commit group: one tap row
constexpr int F_GROUPS = F_KSTEPS / F_CHUNK;      // 4 commit groups per row block
constexpr int F_PIX = CIN * 4;                    // bytes of an f32 pixel (48)
constexpr int F_PATCH = PH * PW * F_PIX;          // 19,200
constexpr int F_COPIES = F_PATCH / 16;            // 16-byte copies per patch (1,200)
constexpr int F_LDC = F_OG + 8;                   // floats per C row: conflict-free float2 stores
// split weights, K-major with the 128-byte swizzle: per 32-k atom column,
// 8 groups of 8 channels x 128 bytes (32 k), 16-byte chunk c of row n at
// chunk c ^ n; groups 1,024 bytes apart (SBO), atom columns 8 KB apart
constexpr int F_W_KATOM = F_OG / 8 * W_GROUP;     // 8,192
constexpr int F_W_BYTES = KDIM / 32 * F_W_KATOM;  // 49,152 for each of w_hi, w_lo
constexpr int F_WLO = F_W_BYTES;
constexpr int F_P_OFF = 2 * F_W_BYTES;                      // 98,304
constexpr int F_C_OFF = F_P_OFF + 2 * F_PATCH;              // 136,704
constexpr int F_SMEM = F_C_OFF + M_VALID * F_LDC * 4 + 1024;  // 220,960 with the slack
static_assert(F_P_OFF % 1024 == 0 && F_PATCH % 16 == 0 && F_C_OFF % 16 == 0,
              "shared regions must stay aligned");
static_assert(F_SMEM <= 232448, "over the 227 KB a block may use");

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// round to TF32 (10 mantissa bits), to nearest with ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64x64] (+)= A[64x8] (registers, the mma.m16n8k8 TF32 A layout per warp)
// * B[8x64] (shared memory, through the descriptor); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(desc));
}

// Copy the f32 patch of xs rows r0..r0+PH, cols c0..c0+PW of one image
// (pixel (i, j) at byte 48 (i PW + j)), zero-filled outside the image.
__device__ __forceinline__ void stage_patch_f32(unsigned char* buf, const float* __restrict__ xb,
                                                int r0, int c0, int Hp, int Wp) {
  for (int i = threadIdx.x; i < F_COPIES; i += THREADS) {
    const int pix = i / 3, R = r0 + pix / PW, C = c0 + pix % PW;
    const bool ok = R >= 0 && R < Hp && C >= 0 && C < Wp;
    cp_async16(buf + 16 * i, ok ? xb + ((size_t)R * Wp + C) * CIN + (i % 3) * 4 : xb,
               ok ? 16 : 0);
  }
}

// Byte offset (within a patch buffer) of the ldmatrix row that this lane
// supplies for m16 row tile mt at k slice 0 (the TF32 fragment: lanes 0-15
// give rows 0-15 at k 0-3, lanes 16-31 the same rows at k 4-7); slice s of
// tap row a adds a*PW*48 + 32*s. Padding rows read position 0 and are
// never stored.
__device__ __forceinline__ int a_row_offset_f32(int mt, int lane) {
  int m = mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  if (m >= M_VALID) m = 0;
  return ((m / TC_W) * PW + m % TC_W) * F_PIX + 16 * (lane >> 4);
}

// The A fragments of commit group c (k8 slices 6c..6c+5, tap row c) of this
// warp's 16 rows, split: hi = rna(v), lo = rna(v - hi)
struct ASplit {
  uint32_t hi[F_CHUNK][4], lo[F_CHUNK][4];
};

__device__ __forceinline__ void load_a_split(ASplit& a, unsigned row, int c) {
#pragma unroll
  for (int s = 0; s < F_CHUNK; ++s) {
    const int kk = c * F_CHUNK + s;  // tap row kk / 6, its slice kk % 6
    uint32_t v[4];
    ldmatrix_x4(v, row + (kk / 6) * PW * F_PIX + 32 * (kk % 6));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a.hi[s][r] = tf32_rna(__uint_as_float(v[r]));
      a.lo[s][r] = tf32_rna(__uint_as_float(v[r]) - __uint_as_float(a.hi[s][r]));
    }
  }
}

// One commit group into a fresh accumulator (part, overwritten by the
// group's first product) that the caller adds into an f32 sum once the
// group is done: the tensor cores truncate each sum they accumulate, so a
// partial of few products keeps that error at the partial's size, and the
// small products (lo*w_hi, hi*w_lo) go first, truncated while part is
// still 2^-11 of its final size; then the group's hi*w_hi.
__device__ __forceinline__ uint64_t w_off(int c, int s) {
  const int kk = c * F_CHUNK + s;
  return (uint64_t)(((kk / 4) * F_W_KATOM + (kk % 4) * 32) >> 4);
}

__device__ __forceinline__ void issue_group(float (&part)[32], const ASplit& a,
                                            uint64_t desc_hi, uint64_t desc_lo, int c) {
  fence_acc(part);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < F_CHUNK; ++s) {
    wgmma_m64n64k8_tf32(part, a.lo[s], desc_hi + w_off(c, s), s);
    wgmma_m64n64k8_tf32(part, a.hi[s], desc_lo + w_off(c, s), 1);
  }
#pragma unroll
  for (int s = 0; s < F_CHUNK; ++s) wgmma_m64n64k8_tf32(part, a.hi[s], desc_hi + w_off(c, s), 1);
  wgmma_commit();
}

// sum += part, once part's commit group is done
__device__ __forceinline__ void add_part(float (&sum)[32], float (&part)[32]) {
  fence_acc(part);
#pragma unroll
  for (int i = 0; i < 32; ++i) sum[i] += part[i];
}

// Bias and ReLU in f32 into the C tile. Thread (g, t) of warp wq holds
// rows 16 wq + g (+8) of row block j and channels 8i + 2t (+1); rows past
// M_VALID are not stored.
__device__ __forceinline__ void epilogue_f32(const float (&d)[32], float* Cs,
                                             const float2 (&bq)[8], int j, int wq, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = j * 64 + wq * 16 + g + 8 * h;
    if (m >= M_VALID) continue;
    float* row = Cs + m * F_LDC + 2 * t;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float2*>(row + 8 * i) =
          make_float2(fmaxf(d[4 * i + 2 * h] + bq[i].x, 0.0f),
                      fmaxf(d[4 * i + 2 * h + 1] + bq[i].y, 0.0f));
  }
}

__device__ __forceinline__ signed char quant_f32(float v) {
  return static_cast<signed char>(fminf(fmaxf(rintf(v), -127.0f), 127.0f));
}

__global__ void __launch_bounds__(THREADS, 1)
s2d_stem_pool_int8_f32_kernel(const float* __restrict__ xs, const float* __restrict__ w,
                              const float* __restrict__ bias, const float* __restrict__ inv,
                              int8_t* __restrict__ out, int B, int Hp, int Wp, int O, int Ho,
                              int Wo) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzled weights need a 1,024-byte aligned base
  const unsigned raw_addr = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  unsigned char* smem = smem_raw + ((1024 - (raw_addr & 1023)) & 1023);
  float* Cs = reinterpret_cast<float*>(smem + F_C_OFF);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp in it

  const int Hc = Hp - 4, Wc = Wp - 4;
  const int tiles_h = (Ho + TP_H - 1) / TP_H, tiles_w = (Wo + TP_W - 1) / TP_W;
  const int per_image = tiles_h * tiles_w, items = B * per_image;
  const int o0 = blockIdx.y * F_OG;  // this block's channel group

  auto tile_origin = [&](int item, int& b, int& p0, int& q0) {
    b = item / per_image;
    const int tl = item % per_image;
    p0 = (tl / tiles_w) * TP_H;
    q0 = (tl % tiles_w) * TP_W;
  };
  auto stage = [&](int item, int buf) {
    int b, p0, q0;
    tile_origin(item, b, p0, q0);
    stage_patch_f32(smem + F_P_OFF + buf * F_PATCH, xs + (size_t)b * Hp * Wp * CIN,
                    2 * p0 - 1, 2 * q0 - 1, Hp, Wp);
  };

  int item = blockIdx.x;
  stage(item, 0);  // the first patch flies while the weights are split
  cp_async_commit();
  // w_hi and w_lo, once per block: element (k, n) at atom column k / 32,
  // group n / 8, row n % 8, chunk (k % 32) / 4 swizzled by the row
  for (int i = tid; i < KDIM * F_OG; i += THREADS) {
    const int k = i / F_OG, n = i % F_OG, kk = k % 32;
    const float v = w[(size_t)k * O + o0 + n];
    const uint32_t hi = tf32_rna(v);
    const int off = (k / 32) * F_W_KATOM + (n / 8) * W_GROUP + (n % 8) * 128 +
                    (((kk / 4) ^ (n % 8)) << 4) + (kk % 4) * 4;
    *reinterpret_cast<uint32_t*>(smem + off) = hi;
    *reinterpret_cast<uint32_t*>(smem + F_WLO + off) = tf32_rna(v - __uint_as_float(hi));
  }
  // the weights are read by wgmma (async proxy) after generic stores
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // descriptors: start >> 4, LBO 1 (unused when swizzled), SBO 1024 >> 4,
  // layout 1 = 128-byte swizzle
  const unsigned w_addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const uint64_t desc_hi = (uint64_t)((w_addr >> 4) & 0x3FFF) | (1ull << 16) |
                           ((uint64_t)(W_GROUP >> 4) << 32) | (1ull << 62);
  const uint64_t desc_lo = desc_hi + (F_WLO >> 4);
  const unsigned p_base = static_cast<unsigned>(__cvta_generic_to_shared(smem + F_P_OFF));

  float2 bq[8];  // the epilogue's bias of this thread's 16 channels
#pragma unroll
  for (int i = 0; i < 8; ++i)
    bq[i] = make_float2(bias[o0 + 8 * i + 2 * (lane & 3)], bias[o0 + 8 * i + 2 * (lane & 3) + 1]);
  const int quad = tid & 15;  // the pool's 4 channels, the same in every round
  const float4 iq = *reinterpret_cast<const float4*>(inv + o0 + 4 * quad);

  if (wg == 1) named_arrive(1, 256);  // warpgroup 0 takes the first turn
  int it = 0;
  for (; item < items; item += gridDim.x, ++it) {
    const int buf = it & 1;
    cp_async_wait_all();
    __syncthreads();  // this patch landed; the last tile's pool is done with C
    // the next tile's patch flies while this one computes
    if (item + (int)gridDim.x < items) stage(item + gridDim.x, buf ^ 1);
    cp_async_commit();
    const unsigned patch = p_base + buf * F_PATCH;

    // row block j of this tile is warpgroup (it + j) & 1's turn: the turns
    // alternate (named barriers 1 and 2) across the 5 blocks and the tiles
#pragma unroll 1
    for (int j = ((it & 1) ^ wg); j < M_BLOCKS; j += 2) {
      const unsigned row = patch + a_row_offset_f32(j * 4 + wq, lane);
      // commit groups alternate between two register sets and two partial
      // sums (x, pa for even groups; y, pb for odd ones); once wait_group 1
      // has seen group c - 2 done, its partial joins the f32 sum and its
      // registers take group c
      ASplit x, y;
      float pa[32], pb[32], sum[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sum[i] = 0.0f;
      load_a_split(x, row, 0);
      named_sync(1 + wg, 256);
      issue_group(pa, x, desc_hi, desc_lo, 0);
#pragma unroll
      for (int c = 1; c < F_GROUPS; ++c) {
        if (c >= 2) wgmma_wait<1>();
        if (c & 1) {
          if (c >= 2) add_part(sum, pb);
          load_a_split(y, row, c);
          issue_group(pb, y, desc_hi, desc_lo, c);
        } else {
          add_part(sum, pa);
          load_a_split(x, row, c);
          issue_group(pa, x, desc_hi, desc_lo, c);
        }
      }
      named_arrive(1 + (wg ^ 1), 256);
      wgmma_wait<0>();
      add_part(sum, pa);
      add_part(sum, pb);
      epilogue_f32(sum, Cs, bq, j, wq, lane);
    }
    __syncthreads();  // C holds the tile's 289 conv positions

    // 3x3/s2 max over the in-window conv positions (a tap outside
    // [0,Hc)x[0,Wc) clamps onto the window's edge and repeats a value),
    // then clip(rint(max * inv), ±127); 4 channels a thread, 4 pooled
    // positions a thread
    int b, p0, q0;
    tile_origin(item, b, p0, q0);
    for (int i = tid; i < TP_H * TP_W * (F_OG / 4); i += THREADS) {
      const int pl = i / (F_OG / 4), p = p0 + pl / TP_W, q = q0 + pl % TP_W;
      if (p >= Ho || q >= Wo) continue;
      int rows[3], cols[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        rows[k] = (min(max(2 * p - 1 + k, 0), Hc - 1) - (2 * p0 - 1)) * TC_W;
        cols[k] = min(max(2 * q - 1 + k, 0), Wc - 1) - (2 * q0 - 1);
      }
      float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // every value is >= 0
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float4 v =
            *reinterpret_cast<const float4*>(Cs + (rows[k / 3] + cols[k % 3]) * F_LDC + 4 * quad);
        m = make_float4(fmaxf(m.x, v.x), fmaxf(m.y, v.y), fmaxf(m.z, v.z), fmaxf(m.w, v.w));
      }
      char4 res;
      res.x = quant_f32(m.x * iq.x);
      res.y = quant_f32(m.y * iq.y);
      res.z = quant_f32(m.z * iq.z);
      res.w = quant_f32(m.w * iq.w);
      *reinterpret_cast<char4*>(out + (((size_t)b * Ho + p) * Wo + q) * O + o0 + 4 * quad) = res;
    }
  }
  // the last turn's hand-over: 5 * it turns, the last by warpgroup (it - 1) & 1
  if (wg == (it & 1)) named_sync(1 + wg, 256);
  cp_async_wait_all();
}

}  // namespace

extern "C" int automoe_stem_s2d_pool_int8(const void* xs, const void* w,
                                          const void* bias, const void* inv,
                                          void* out, int B, int Hp, int Wp,
                                          int O, void* stream) {
  if (B <= 0 || Hp <= 4 || Wp <= 4 || O <= 0 || O % 64 != 0)
    return (int)cudaErrorInvalidValue;
  const int Hc = Hp - 4, Wc = Wp - 4;
  const int Ho = (Hc - 1) / 2 + 1, Wo = (Wc - 1) / 2 + 1;
  // the shared-memory opt-in and the SM count, once per process and device
  constexpr int MAX_DEV = 64;
  static int sm_count[MAX_DEV];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  if (!sm_count[dev]) {
    e = cudaFuncSetAttribute(s2d_stem_pool_int8_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, STEM_SMEM);
    if (e != cudaSuccess) return (int)e;
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sm_count[dev] = n;
  }
  const long long items =
      (long long)B * ((Ho + TP_H - 1) / TP_H) * ((Wo + TP_W - 1) / TP_W);
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int groups = (O + OG - 1) / OG;
  const int per_group = sm_count[dev] / groups > 0 ? sm_count[dev] / groups : 1;
  const dim3 grid((unsigned)(items < per_group ? items : per_group), groups);
  s2d_stem_pool_int8_kernel<<<grid, THREADS, STEM_SMEM, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(xs), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(inv),
      static_cast<int8_t*>(out), B, Hp, Wp, O, Ho, Wo);
  return (int)cudaGetLastError();
}

extern "C" int automoe_stem_s2d_pool_int8_f32(const void* xs, const void* w,
                                              const void* bias, const void* inv,
                                              void* out, int B, int Hp, int Wp,
                                              int O, void* stream) {
  if (B <= 0 || Hp <= 4 || Wp <= 4 || O <= 0 || O % F_OG != 0)
    return (int)cudaErrorInvalidValue;
  const int Hc = Hp - 4, Wc = Wp - 4;
  const int Ho = (Hc - 1) / 2 + 1, Wo = (Wc - 1) / 2 + 1;
  constexpr int MAX_DEV = 64;
  static int sm_count[MAX_DEV];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  if (!sm_count[dev]) {
    e = cudaFuncSetAttribute(s2d_stem_pool_int8_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
    if (e != cudaSuccess) return (int)e;
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sm_count[dev] = n;
  }
  const long long items =
      (long long)B * ((Ho + TP_H - 1) / TP_H) * ((Wo + TP_W - 1) / TP_W);
  const int groups = O / F_OG;
  if (items > 0x7fffffffLL || groups > 65535) return (int)cudaErrorInvalidValue;
  // one resident block an SM, shared out between the channel groups
  const int per_group = sm_count[dev] / groups > 0 ? sm_count[dev] / groups : 1;
  const dim3 grid((unsigned)(items < per_group ? items : per_group), groups);
  s2d_stem_pool_int8_f32_kernel<<<grid, THREADS, F_SMEM, (cudaStream_t)stream>>>(
      static_cast<const float*>(xs), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(inv),
      static_cast<int8_t*>(out), B, Hp, Wp, O, Ho, Wo);
  return (int)cudaGetLastError();
}

extern "C" int automoe_maxpool3x3s2_int8(const void* x, void* out, int B, int H,
                                         int W, int C, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int Ho = (H - 1) / 2 + 1, Wo = (W - 1) / 2 + 1;
  const long long n = (long long)B * Ho * Wo * (C / 16);
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  maxpool3x3s2_int8_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), B, H, W, C, Ho, Wo);
  return (int)cudaGetLastError();
}
