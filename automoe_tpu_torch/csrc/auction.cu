// Auction assignment with exact Jonker-Volgenant escalation, for sm_90a.
//
// Replaces the TPU kernels of automoe_tpu/ops/pallas_auction.py:
//   K1 `_auction_kernel` (:157): single-phase forward auction (Bertsekas),
//      one batch element per program;
//   K2 `_jv_exact` (:39): exact Jonker-Volgenant from scratch for an element
//      still unconverged at the iteration cap, inside the same launch.
//
// Design: one thread block per batch element; the whole solver state lives
// in shared memory for the life of the block: benefit [N,Q], price [Q],
// person_obj [N] and the bids for the auction, u [N] and v, minv, used,
// way, owner [Q] for JV. Device memory is read once (benefit, valid, eps)
// and written once (the assignment), so the bytes bound this kernel at
// ~0.12 us for 32x48x64; what it really spends is the data-dependent loop
// count (auction iterations, JV Dijkstra scans), each a few block-wide
// reductions and barriers. A simple kernel first: no wgmma/TMA (there is
// no matrix product here), one column per thread, one warp per bidding row.
//
// Numerics: every f32 operation is the JAX kernel's, in its order
// (values = benefit - price; bid = (v1 - v2) + eps; cur = (row - u_i0) - v;
// minv - delta; ...), written with __fadd_rn/__fsub_rn so that nothing is
// contracted or reordered; maxima and minima are exact. Ties resolve as in
// JAX: first argmax column per row, lowest bidding row per column, first
// column with dm <= delta. The kernel and its plain PyTorch version
// (ops/auction_kernel.py) therefore return identical assignments.
//
// Rows are persons (targets, N), columns are objects (queries, Q). Output
// is -1 for invalid or unassigned rows.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e9f;
constexpr float JV_INF = 1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Smem {
  float* ben;    // [N*Q]
  float* price;  // [Q]
  float* v;      // [Q]
  float* minv;   // [Q]
  float* bid;    // [N]
  float* u;      // [N]
  float* redf;   // [33]
  int* best;     // [N]  bid column of a bidding row, -1 otherwise
  int* pobj;     // [N]
  int* vld;      // [N]
  int* winn;     // [Q]  winning row of a column this round, -1 if none
  int* used;     // [Q]
  int* way;      // [Q]
  int* owner;    // [Q]
  int* redi;     // [33]
};

__host__ __device__ inline int smem_words(int N, int Q) {
  return N * Q + 7 * Q + 5 * N + 2 * 33;
}

__device__ inline Smem carve(float* base, int N, int Q) {
  Smem s;
  s.ben = base;
  s.price = s.ben + N * Q;
  s.v = s.price + Q;
  s.minv = s.v + Q;
  s.bid = s.minv + Q;
  s.u = s.bid + N;
  s.redf = s.u + N;
  int* ib = reinterpret_cast<int*>(s.redf + 33);
  s.best = ib;
  s.pobj = s.best + N;
  s.vld = s.pobj + N;
  s.winn = s.vld + N;
  s.used = s.winn + Q;
  s.way = s.used + Q;
  s.owner = s.way + Q;
  s.redi = s.owner + Q;
  return s;
}

__device__ inline float warp_max(float x) {
  for (int off = 16; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ inline int warp_min(int x) {
  for (int off = 16; off; off >>= 1) x = min(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// lexicographic (value, index) minimum: the first index of the least value
__device__ inline void argmin_step(float& d, int& j, float d2, int j2) {
  if (d2 < d || (d2 == d && j2 < j)) {
    d = d2;
    j = j2;
  }
}

// Block-wide first-argmin over (d, j); every thread gets the result.
__device__ inline void block_argmin(const Smem& s, float& d, int& j) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off; off >>= 1)
    argmin_step(d, j, __shfl_down_sync(FULL, d, off), __shfl_down_sync(FULL, j, off));
  if (lane == 0) {
    s.redf[warp] = d;
    s.redi[warp] = j;
  }
  __syncthreads();
  if (warp == 0) {
    d = lane < WARPS ? s.redf[lane] : INFINITY;
    j = lane < WARPS ? s.redi[lane] : 0x7fffffff;
    for (int off = 16; off; off >>= 1)
      argmin_step(d, j, __shfl_down_sync(FULL, d, off), __shfl_down_sync(FULL, j, off));
    if (lane == 0) {
      s.redf[32] = d;
      s.redi[32] = j;
    }
  }
  __syncthreads();
  d = s.redf[32];
  j = s.redi[32];
}

// ---------------------------------------------------------------------------
// K2: exact JV from scratch on cost = -benefit (pallas_auction.py:39-154)
// ---------------------------------------------------------------------------
__device__ void jv_exact(const Smem& s, int N, int Q) {
  const int tid = threadIdx.x;
  for (int j = tid; j < Q; j += THREADS) {
    s.v[j] = 0.f;
    s.owner[j] = -1;
  }
  for (int n = tid; n < N; n += THREADS) s.u[n] = 0.f;
  __syncthreads();

  for (int i = 0; i < N; ++i) {
    int any_free = 0;
    for (int j = tid; j < Q; j += THREADS) any_free |= s.owner[j] < 0;
    any_free = __syncthreads_or(any_free);
    if (!s.vld[i] || !any_free) continue;
    for (int j = tid; j < Q; j += THREADS) {
      s.minv[j] = JV_INF;
      s.used[j] = 0;
      s.way[j] = -1;
    }
    __syncthreads();

    // Dijkstra over reduced costs; the owners do not change until augment
    int j0 = -1, found = 0;
    for (int it = 0; found == 0 && it <= Q; ++it) {
      const int i0 = j0 < 0 ? i : s.owner[j0];
      const bool row_ok = i0 >= 0 && i0 < N;
      const float u_i0 = row_ok ? s.u[i0] : 0.f;
      float d = INFINITY;
      int jd = 0x7fffffff;
      for (int j = tid; j < Q; j += THREADS) {
        if (j == j0) s.used[j] = 1;
        float dm = JV_INF;
        if (!s.used[j]) {
          const float row = row_ok ? -s.ben[i0 * Q + j] : JV_INF;
          const float cur = __fsub_rn(__fsub_rn(row, u_i0), s.v[j]);
          float mv = s.minv[j];
          if (cur < mv) {
            mv = cur;
            s.minv[j] = cur;
            s.way[j] = j0;
          }
          dm = mv;
        }
        argmin_step(d, jd, dm, j);
      }
      block_argmin(s, d, jd);  // ends with a barrier: u_i0 reads are done
      const float delta = d;
      const int j1 = jd < Q ? jd : Q;
      // dual update: owners of used columns and the start row gain delta,
      // used columns' prices drop, unscanned distances shrink. Each row
      // owns at most one column and row i owns none, so no two threads
      // write the same u.
      for (int j = tid; j < Q; j += THREADS) {
        if (s.used[j]) {
          s.v[j] = __fsub_rn(s.v[j], delta);
          const int o = s.owner[j];
          if (o >= 0) s.u[o] = __fadd_rn(s.u[o], delta);
        } else {
          s.minv[j] = __fsub_rn(s.minv[j], delta);
        }
      }
      if (tid == 0) s.u[i] = __fadd_rn(s.u[i], delta);
      __syncthreads();
      found = j1 >= Q ? 2 : (s.owner[j1] < 0 ? 1 : 0);
      j0 = j1;
    }

    // augment: shift ownership along the predecessor path (lapjv.cpp order)
    if (tid == 0) {
      int j = j0, done = 0;
      for (int it = 0; done == 0 && it <= N + 1; ++it) {
        const bool j_ok = j >= 0 && j < Q;
        const int pj = j_ok ? s.way[j] : 0;
        const int prev_owner = (pj >= 0 && pj < Q) ? s.owner[pj] : 0;
        const int new_owner = pj < 0 ? i : prev_owner;
        if (j_ok) s.owner[j] = new_owner;
        done = pj < 0;
        j = pj;
      }
    }
    __syncthreads();
  }

  for (int n = tid; n < N; n += THREADS) s.pobj[n] = -1;
  __syncthreads();
  for (int j = tid; j < Q; j += THREADS) {
    const int o = s.owner[j];
    if (o >= 0 && o < N) s.pobj[o] = j;  // owners are unique
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K1: forward auction (pallas_auction.py:157-239), then K2 if unconverged
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
auction_kernel(const float* __restrict__ benefit, const int* __restrict__ valid,
               const float* __restrict__ eps_arr, int* __restrict__ out, int N, int Q,
               int max_iters) {
  extern __shared__ float smem[];
  const Smem s = carve(smem, N, Q);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* ben_g = benefit + static_cast<size_t>(b) * N * Q;
  for (int k = tid; k < N * Q; k += THREADS) s.ben[k] = ben_g[k];
  for (int n = tid; n < N; n += THREADS) {
    s.vld[n] = valid[static_cast<size_t>(b) * N + n] != 0;
    s.pobj[n] = -1;
  }
  for (int j = tid; j < Q; j += THREADS) s.price[j] = 0.f;
  const float eps = eps_arr[b];
  __syncthreads();

  for (int it = 0;; ++it) {
    int pending = 0;
    for (int n = tid; n < N; n += THREADS) pending |= s.pobj[n] < 0 && s.vld[n];
    pending = __syncthreads_or(pending);
    if (!pending || it >= max_iters) break;

    // 1. bids: one warp per row; v1 = max value, best = its first column,
    //    v2 = max with that column masked to NEG, bid = (v1 - v2) + eps
    for (int n = warp; n < N; n += WARPS) {
      if (!(s.pobj[n] < 0 && s.vld[n])) {
        if (lane == 0) s.best[n] = -1;
        continue;
      }
      const float* row = s.ben + n * Q;
      float m = -INFINITY;
      for (int j = lane; j < Q; j += 32) m = fmaxf(m, __fsub_rn(row[j], s.price[j]));
      const float v1 = warp_max(m);
      int bj = Q;
      for (int j = lane; j < Q; j += 32) {
        if (__fsub_rn(row[j], s.price[j]) >= v1) {
          bj = j;
          break;
        }
      }
      bj = warp_min(bj);
      float m2 = NEG;  // the masked column's value
      for (int j = lane; j < Q; j += 32)
        if (j != bj) m2 = fmaxf(m2, __fsub_rn(row[j], s.price[j]));
      const float v2 = warp_max(m2);
      if (lane == 0) {
        // no column reaches v1 only for NaN values: JAX's best_j is then
        // Q, which matches no column, so the row places no bid
        s.best[n] = bj < Q ? bj : -1;
        s.bid[n] = __fadd_rn(__fsub_rn(v1, v2), eps);
      }
    }
    __syncthreads();

    // 2. winners: one thread per column takes the highest bid, lowest row
    //    on ties; its price rises by the winning bid
    for (int j = tid; j < Q; j += THREADS) {
      float wv = -INFINITY;
      int wn = -1;
      for (int n = 0; n < N; ++n) {
        if (s.best[n] == j && s.bid[n] > wv) {
          wv = s.bid[n];
          wn = n;
        }
      }
      const bool has_bid = wn >= 0 && wv > NEG * 0.5f;
      s.winn[j] = has_bid ? wn : -1;
      if (has_bid) s.price[j] = __fadd_rn(s.price[j], wv);
    }
    __syncthreads();

    // 3. update: a holder of a re-won column loses it, a winner takes its
    //    column (bidders hold nothing, so the two never meet)
    for (int n = tid; n < N; n += THREADS) {
      const int po = s.pobj[n], bj = s.best[n];
      if (bj >= 0 && s.winn[bj] == n) {
        s.pobj[n] = bj;
      } else if (po >= 0 && s.winn[po] >= 0) {
        s.pobj[n] = -1;
      }
    }
    __syncthreads();
  }

  int unconverged = 0;
  for (int n = tid; n < N; n += THREADS) unconverged |= s.pobj[n] < 0 && s.vld[n];
  if (__syncthreads_or(unconverged)) jv_exact(s, N, Q);
  for (int n = tid; n < N; n += THREADS) out[static_cast<size_t>(b) * N + n] = s.pobj[n];
}

}  // namespace

// dynamic shared memory of one block; the wrapper rejects shapes above
// the 227 KB a block may use
extern "C" int automoe_auction_smem_bytes(int N, int Q) {
  return 4 * smem_words(N, Q);
}

// benefit [B,N,Q] f32 (invalid rows 0), valid [B,N] i32, eps [B] f32 →
// out [B,N] i32. Launches on `stream`, does not synchronise; returns the
// launch's cudaError_t.
extern "C" int automoe_auction_solve(const void* benefit, const void* valid, const void* eps,
                                     void* out, int B, int N, int Q, int max_iters,
                                     void* stream) {
  const int bytes = automoe_auction_smem_bytes(N, Q);
  cudaError_t e = cudaFuncSetAttribute(auction_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  auction_kernel<<<B, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(benefit), static_cast<const int*>(valid),
      static_cast<const float*>(eps), static_cast<int*>(out), N, Q, max_iters);
  return static_cast<int>(cudaGetLastError());
}
