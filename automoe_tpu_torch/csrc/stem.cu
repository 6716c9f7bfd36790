// Int8 serving stem kernels for Hopper (sm_90a), with a plain C interface
// (loaded through ctypes by automoe_tpu_torch/ops/stem.py; no PyTorch
// headers, so the build takes seconds).
//
// K3  automoe_stem_s2d_pool_int8 replaces automoe_tpu/ops/pallas_stem.py
//     _stem_kernel (launched by s2d_stem_pool_int8). It computes, for all
//     experts' stems at once,
//       out = maxpool3x3s2_SAME( clip(rint((conv4x4(xs, w) + bias)^+ * inv), ±127) )
//     over the 2x2 space-to-depth image xs [B,Hc+4,Wc+4,12] (bf16), with w
//     the [192,O] bf16 matrix of the rewritten 4x4/s1 kernel (row
//     (a*4+b)*12+c), bias and inv [O] f32, out [B,Ho,Wo,O] int8.
//     Bound: at B=128, 256x256 input it does 206 GFLOP in bf16 against
//     188 MB of compulsory traffic, so the tensor cores bound it (0.21 ms
//     at the H100's 989 TFLOP/s vs 0.06 ms for the bytes). What it keeps
//     out of device memory is the pre-pool [B,Hc,Wc,O] tensor: each block
//     holds its conv tile in shared memory and writes only pooled int8.
//     Design: one block per (image, 4x8 pooled tile, 64 output channels).
//     The block builds the im2col matrix of its 9x17 conv positions
//     (padded to 160 rows) in shared memory, multiplies it by the 192x64
//     weight slice with WMMA bf16 tensor-core tiles (f32 accumulation),
//     then pools the f32 sums and quantizes. Because x -> fl(x+b), ReLU
//     and x -> fl(x*inv) (inv > 0) are monotone, pooling the raw sums and
//     then adding bias/ReLU/quantizing once is exactly quantize-then-pool.
//     Conv positions outside [0,Hc)x[0,Wc) are skipped, i.e. SAME padding
//     with -inf. Every global->shared copy is a cp.async issued up front
//     (zero-filled where the position is out of range), so a block waits
//     on memory once, not once per copy. Not yet: TMA, wgmma, pipelining
//     across tiles, or one im2col shared by all output channels.
//
// K4  automoe_maxpool3x3s2_int8 replaces automoe_tpu/ops/pallas_stem.py
//     _pool_kernel (launched by maxpool3x3s2_int8): 3x3/s2 SAME max-pool
//     of an int8 NHWC tensor (out-of-range taps skipped, which is the
//     reduce_window -128 pad). Memory-bound (5.2 MB per 128x128x256
//     image in and out); one thread per (pixel, 16 channels) with 16-byte
//     loads and per-byte __vmaxs4.
//
// Every entry point launches on the given stream, allocates nothing and
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

// cp.async: global -> shared without a register round trip. With
// src_bytes 0 the 8 destination bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

constexpr int CIN = 12;                      // s2d channels
constexpr int KDIM = 16 * CIN;               // 4x4 taps x 12 = 192
constexpr int TP_H = 4;                      // pooled rows per block
constexpr int TP_W = 8;                      // pooled cols per block
constexpr int TC_H = 2 * TP_H + 1;           // conv rows per block (9)
constexpr int TC_W = 2 * TP_W + 1;           // conv cols per block (17)
constexpr int M_VALID = TC_H * TC_W;         // 153 conv positions
constexpr int M_TILES = (M_VALID + 15) / 16; // 10
constexpr int M_PAD = M_TILES * 16;          // 160
constexpr int OC = 64;                       // output channels per block
constexpr int N_TILES = OC / 16;             // 4
constexpr int LDA = KDIM + 8;                // bf16 row pitch of A (skews banks)
constexpr int LDB = OC + 8;                  // bf16 row pitch of W
constexpr int LDC = OC + 4;                  // f32 row pitch of C
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int M_GROUPS = WARPS / N_TILES;    // warps sharing a column tile
constexpr int MT_PER_WARP = M_TILES / M_GROUPS;
static_assert(M_TILES % M_GROUPS == 0, "row tiles must split evenly");
constexpr size_t A_BYTES = size_t(M_PAD) * LDA * 2;
constexpr size_t C_BYTES = size_t(M_PAD) * LDC * 4;
constexpr size_t AC_BYTES = A_BYTES > C_BYTES ? A_BYTES : C_BYTES;
constexpr size_t B_BYTES = size_t(KDIM) * LDB * 2;
constexpr size_t STEM_SMEM = AC_BYTES + B_BYTES;  // 91,648 bytes
static_assert(AC_BYTES % 128 == 0, "W slice must stay 128-byte aligned");

__global__ void __launch_bounds__(THREADS)
s2d_stem_pool_int8_kernel(const __nv_bfloat16* __restrict__ xs,
                          const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ inv,
                          int8_t* __restrict__ out,
                          int Hp, int Wp, int O, int Ho, int Wo) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);  // reuses As after the MMAs
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + AC_BYTES);

  const int Hc = Hp - 4, Wc = Wp - 4;
  const int n_oc = O / OC;
  const int b = blockIdx.z / n_oc;
  const int oc0 = (blockIdx.z % n_oc) * OC;
  const int p0 = blockIdx.y * TP_H, q0 = blockIdx.x * TP_W;
  const int r0 = 2 * p0 - 1, c0 = 2 * q0 - 1;  // first conv row/col of the tile
  const int tid = threadIdx.x;

  // 1. weight slice W[:, oc0:oc0+64], 16 bytes per copy
  for (int i = tid; i < KDIM * (OC / 8); i += THREADS) {
    const int k = i / (OC / 8), j = i % (OC / 8);
    cp_async16(Bs + k * LDB + j * 8, w + (size_t)k * O + oc0 + j * 8);
  }
  // 2. im2col: A[m, a*48 + t] = xs[b, r+a, c + t/12, t%12] for the conv
  //    position m = (r-r0)*TC_W + (c-c0). For one (m, a) the 48 values are
  //    contiguous in xs (4 columns x 12 channels): 12 copies of 8 bytes,
  //    zero-filled for padding rows and out-of-range positions.
  const __nv_bfloat16* xb = xs + (size_t)b * Hp * Wp * CIN;
  for (int i = tid; i < M_PAD * 4 * 12; i += THREADS) {
    const int j = i % 12, a = (i / 12) % 4, m = i / 48;
    const int r = r0 + m / TC_W, c = c0 + m % TC_W;
    const bool valid = m < M_VALID && r >= 0 && r < Hc && c >= 0 && c < Wc;
    const __nv_bfloat16* src =
        valid ? xb + ((size_t)(r + a) * Wp + c) * CIN + j * 4 : xb;
    cp_async8(As + m * LDA + a * 48 + j * 4, src, valid ? 8 : 0);
  }
  cp_async_wait_all();
  __syncthreads();

  // 3. C[160,64] = A[160,192] @ W[192,64]: warp w owns column tile w % 4
  //    and row tiles w/4, w/4 + 2, ..., accumulating in f32.
  const int warp = tid / 32;
  const int nt = warp % N_TILES;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT_PER_WARP];
#pragma unroll
  for (int i = 0; i < MT_PER_WARP; ++i) wmma::fill_fragment(acc[i], 0.0f);
#pragma unroll 2
  for (int kk = 0; kk < KDIM / 16; ++kk) {
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
    wmma::load_matrix_sync(bf, Bs + kk * 16 * LDB + nt * 16, LDB);
#pragma unroll
    for (int i = 0; i < MT_PER_WARP; ++i) {
      const int mt = warp / N_TILES + i * M_GROUPS;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
      wmma::load_matrix_sync(af, As + mt * 16 * LDA + kk * 16, LDA);
      wmma::mma_sync(acc[i], af, bf, acc[i]);
    }
  }
  __syncthreads();  // all warps are done with As before Cs overwrites it
#pragma unroll
  for (int i = 0; i < MT_PER_WARP; ++i) {
    const int mt = warp / N_TILES + i * M_GROUPS;
    wmma::store_matrix_sync(Cs + mt * 16 * LDC + nt * 16, acc[i], LDC,
                            wmma::mem_row_major);
  }
  __syncthreads();

  // 4. 3x3/s2 max over the raw f32 sums, then bias, ReLU, quantize.
  const int ch = tid % OC;
  const float bch = bias[oc0 + ch];
  const float ich = inv[oc0 + ch];
  for (int t = tid / OC; t < TP_H * TP_W; t += THREADS / OC) {
    const int p = p0 + t / TP_W, q = q0 + t % TP_W;
    if (p >= Ho || q >= Wo) continue;
    float mx = -INFINITY;
    for (int dr = 0; dr < 3; ++dr) {
      const int r = 2 * p - 1 + dr;
      if (r < 0 || r >= Hc) continue;
      for (int dc = 0; dc < 3; ++dc) {
        const int c = 2 * q - 1 + dc;
        if (c < 0 || c >= Wc) continue;
        mx = fmaxf(mx, Cs[((r - r0) * TC_W + (c - c0)) * LDC + ch]);
      }
    }
    const float v = fmaxf(mx + bch, 0.0f);
    // rintf rounds half to even, as jnp.round / torch.round do
    const float qv = fminf(fmaxf(rintf(v * ich), -127.0f), 127.0f);
    out[(((size_t)b * Ho + p) * Wo + q) * O + oc0 + ch] = (int8_t)qv;
  }
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

}  // namespace

extern "C" int automoe_stem_s2d_pool_int8(const void* xs, const void* w,
                                          const void* bias, const void* inv,
                                          void* out, int B, int Hp, int Wp,
                                          int O, void* stream) {
  if (B <= 0 || Hp <= 4 || Wp <= 4 || O <= 0 || O % OC != 0)
    return (int)cudaErrorInvalidValue;
  const int Hc = Hp - 4, Wc = Wp - 4;
  const int Ho = (Hc - 1) / 2 + 1, Wo = (Wc - 1) / 2 + 1;
  cudaError_t e = cudaFuncSetAttribute(
      s2d_stem_pool_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)STEM_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Wo + TP_W - 1) / TP_W, (Ho + TP_H - 1) / TP_H, B * (O / OC));
  s2d_stem_pool_int8_kernel<<<grid, THREADS, STEM_SMEM, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(xs), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<const float*>(inv),
      static_cast<int8_t*>(out), Hp, Wp, O, Ho, Wo);
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
