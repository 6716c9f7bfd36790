// Auction assignment with exact Jonker-Volgenant escalation, for sm_90a.
//
// Replaces the TPU kernels of automoe_tpu/ops/pallas_auction.py:
//   K1 `_auction_kernel` (:157): single-phase forward auction (Bertsekas),
//      one batch element per program, and its escalate=False greedy
//      completion (:242-276);
//   K2 `_jv_exact` (:39): exact Jonker-Volgenant from scratch for an element
//      still unconverged at the iteration cap, inside the same launch.
//
// What bounds it on this card. Device memory is read once (benefit, valid,
// eps) and written once (the assignment): ~0.12 us of bytes for 32x48x64.
// The time goes into chains of dependent steps inside one element:
// auction rounds until every valid row holds a column (or the cap), JV's
// Dijkstra scans (at most Q+1 per person) and the augment walk. Blocks of
// other elements run beside it on other SMs but cannot shorten a chain,
// so the design shortens each link:
//
// - One block per batch element, the whole state in shared memory for the
//   life of the block: benefit [N,Q], prices, the per-column winner keys,
//   the column owners, each row's column, and bitmaps of the valid and of
//   the bidding rows. The kernel is a template on the columns a lane
//   walks (CPL = 1, 2, 4, 8 for Q <= 32, 64, 128, 256; 0: a loop, any Q),
//   so that the per-column loops unroll into selects and JV's column
//   state fits in registers.
// - A round has two block barriers:
//   1. bids: each warp takes the bidding rows of its rank (from the
//      bidding bitmap, so no warp reads the state of a row that does not
//      bid). A lane computes benefit - price once for each of its columns
//      (one pass) and keeps a top-2: the largest value v1, its first
//      column, and the second value v2, which equals v1 when another column
//      ties it. The warp merges the lanes' top-2 with three redux.sync on
//      order-preserving keys (max of v1, lowest column at it, max of the
//      runners-up) and lane 0 posts bid = (v1 - v2) + eps with one 64-bit
//      shared-memory atomicMax on its column's key: the high word holds
//      the bid's order-preserving bits (-0 made +0), the low word N-1-n,
//      so the highest bid and, among equal bids, the lowest row wins,
//      whatever order the atomics land in. Bids not above NEG/2 are not
//      posted (JAX's has_bid). No bidder left ends the auction.
//   2. winners: one thread per column reads and clears its key, raises the
//      price, moves the column from its holder to the winner and flips both
//      rows' bits in the bidding bitmap (atomicXor): price, evict/award and
//      the next round's bidders in one pass, no scan over rows.
// - JV runs in one warp (jv_exact_regs): lane l owns columns l + 32c with
//   v, minv, used, way, owner and the owner's u in registers. Each
//   Dijkstra scan is one shared-memory load of the benefit row, an exact
//   warp first-argmin (two redux.sync: the least key, then the lowest
//   column at it) and two shuffles (owner and u of the found column, the
//   next scan's row); no barrier, no shared-memory write. All lanes walk
//   the augment path by shuffles. The other warps wait at one barrier at
//   the end. For Q > 256 the same steps keep the column state in shared
//   memory (jv_exact_shared). The greedy completion (escalate=False) is
//   one warp too, row after row.
// - No TMA, wgmma or clusters: there is no matrix product, and an element's
//   input is 12 KB that one block loads once.
//
// Numerics: every f32 operation is the JAX kernel's, in its order
// (values = benefit - price; bid = (v1 - v2) + eps; cur = (row - u_i0) - v;
// minv - delta; ...), written with __fadd_rn/__fsub_rn and built with
// --fmad=false so that nothing is contracted or reordered; maxima and
// minima are exact. Ties resolve as in JAX: first argmax column per row,
// lowest bidding row per column, first column with dm <= delta. NaN values
// never bid and never win a scan. The kernel and its plain PyTorch version
// (ops/auction_kernel.py) return identical assignments.
//
// Rows are persons (targets, N), columns are objects (queries, Q). Output
// is -1 for invalid or unassigned rows.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e9f;
constexpr float JV_INF = 1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_KEY = 0xffffffffu;  // NaN, or no column: loses every min

// Shared state of one element. jv_exact_shared's arrays reuse the
// auction's, which are dead by then: v <- price, minv and used <- the
// 64-bit keys.
struct Smem {
  unsigned long long* key;  // [Q] winner key of this round's bids (0: none)
  float* ben;               // [N*Q]
  float* price;             // [Q] (JV: v)
  float* minv;              // [Q] JV (aliases key's first half)
  int* used;                // [Q] JV (aliases key's second half)
  int* owner;               // [Q] row holding the column, -1 if none (auction, then JV)
  int* way;                 // [Q] JV predecessor column
  int* pobj;                // [N] column held by the row, -1 if none
  float* u;                 // [N] JV row potential (jv_exact_shared)
  unsigned* bidding;        // [W] rows that are valid and hold nothing
  unsigned* valid;          // [W]
};

__host__ __device__ inline int words(int N) { return (N + 31) / 32; }

__host__ __device__ inline int smem_bytes(int N, int Q) {
  return 8 * Q + 4 * (N * Q + 3 * Q + 2 * N + 2 * words(N));
}

__device__ inline Smem carve(unsigned char* base, int N, int Q) {
  Smem s;
  s.key = reinterpret_cast<unsigned long long*>(base);
  s.minv = reinterpret_cast<float*>(base);
  s.used = reinterpret_cast<int*>(base + 4 * Q);
  s.ben = reinterpret_cast<float*>(base + 8 * Q);
  s.price = s.ben + N * Q;
  s.owner = reinterpret_cast<int*>(s.price + Q);
  s.way = s.owner + Q;
  s.pobj = s.way + Q;
  s.u = reinterpret_cast<float*>(s.pobj + N);
  s.bidding = reinterpret_cast<unsigned*>(s.u + N);
  s.valid = s.bidding + words(N);
  return s;
}

// Order-preserving key of a float: unsigned order = float order for
// non-NaN values, -0 = +0 (x + 0 is +0 for x = -0 under round to nearest).
__device__ inline unsigned fkey(float x) {
  const int b = __float_as_int(__fadd_rn(x, 0.0f));
  return static_cast<unsigned>(b ^ ((b >> 31) | static_cast<int>(0x80000000u)));
}

__device__ inline float funkey(unsigned k) {
  return __int_as_float(static_cast<int>(k ^ (~(static_cast<int>(k) >> 31) | 0x80000000u)));
}

// Columns a lane walks: CPL > 0 fixes the count at compile time (Q <= 32
// CPL, the loops unroll and keep their state in registers), CPL = 0 walks
// ceil(Q/32) at run time.
template <int CPL>
__device__ inline int lane_cols(int Q) {
  return CPL ? CPL : (Q + 31) / 32;
}

// Exact first-argmin over the warp of each lane's (key, column): every lane
// gets the least key and the lowest column holding it; (NO_KEY, Q) if no
// lane has a key.
__device__ inline void warp_argmin(unsigned& k, int& j, int Q) {
  const unsigned m = __reduce_min_sync(FULL, k);
  const unsigned jm = __reduce_min_sync(FULL, static_cast<unsigned>(k == m ? j : Q));
  j = m == NO_KEY ? Q : static_cast<int>(jm);
  k = m;
}

// ---------------------------------------------------------------------------
// K1's bid of row n (pallas_auction.py:176-186), by one warp; lane 0 posts it
// ---------------------------------------------------------------------------
template <int CPL>
__device__ inline void bid_row(const Smem& s, int n, int N, int Q, float eps, int lane) {
  const float* row = s.ben + n * Q;
  // lane-local top-2 over this lane's columns, in column order: v1, its
  // first column j1 (Q: none yet) and the runner-up v2 (NEG at least, as
  // JAX masks the best column to NEG; fmaxf drops a NaN)
  float v1 = -INFINITY, v2 = NEG;
  int j1 = Q;
#pragma unroll
  for (int c = 0; c < lane_cols<CPL>(Q); ++c) {
    const int j = lane + 32 * c;
    const bool live = j < Q;
    const float val = live ? __fsub_rn(row[j], s.price[j]) : NEG;
    const bool take = live && (val > v1 || (j1 == Q && val >= v1));
    v2 = fmaxf(v2, take ? v1 : val);  // = v1 when a second column reaches v1
    v1 = take ? val : v1;
    j1 = take ? j : j1;
  }
  // merge: the row's v1, its first column, then the largest of every
  // other lane's v1 and the best lane's v2
  const unsigned k1 = j1 < Q ? fkey(v1) : 0u;
  const unsigned m1 = __reduce_max_sync(FULL, k1);
  const int bj = static_cast<int>(
      __reduce_min_sync(FULL, static_cast<unsigned>(j1 < Q && k1 == m1 ? j1 : Q)));
  if (bj >= Q) return;  // every value NaN: JAX's best_j matches no column
  const unsigned m2 = __reduce_max_sync(FULL, fkey(j1 == bj ? v2 : fmaxf(v1, NEG)));
  if (lane == 0) {
    const float bid = __fadd_rn(__fsub_rn(funkey(m1), funkey(m2)), eps);
    if (bid > NEG * 0.5f)
      atomicMax(&s.key[bj], (static_cast<unsigned long long>(fkey(bid)) << 32) |
                                static_cast<unsigned>(N - 1 - n));
  }
}

// ---------------------------------------------------------------------------
// K1's winner of column j (pallas_auction.py:188-210): the key's bid raises
// the price, its row takes the column from the holder, both rows flip in
// the bidding bitmap (the winner bid, so it held nothing: no row is written
// twice); the key is cleared for the next round
// ---------------------------------------------------------------------------
__device__ __forceinline__ void settle(const Smem& s, int j, int N, float& price, int& owner) {
  const unsigned long long k = s.key[j];
  if (!k) return;
  s.key[j] = 0ull;
  const int n = N - 1 - static_cast<int>(k & 0xffffffffu);
  price = __fadd_rn(price, funkey(static_cast<unsigned>(k >> 32)));
  s.price[j] = price;
  const int o = owner;
  owner = n;
  s.owner[j] = n;
  s.pobj[n] = j;
  atomicXor(&s.bidding[n >> 5], 1u << (n & 31));
  if (o >= 0) {
    s.pobj[o] = -1;
    atomicXor(&s.bidding[o >> 5], 1u << (o & 31));
  }
}

// ---------------------------------------------------------------------------
// K2: exact JV from scratch on cost = -benefit (pallas_auction.py:39-154),
// by warp 0 alone; ends with pobj set from the owners.
// jv_exact_regs<CPL> (Q <= 32 CPL): lane l's columns l + 32c, c < CPL, keep
// v, minv, used, way, owner and their owner's u in registers. A scan's
// chain is one shared-memory load (the benefit row), two redux.sync (the
// argmin) and two shuffles (owner and u of the found column, which are
// the next scan's row); nothing is written to shared memory.
// jv_exact_shared: the same steps with the column state in shared memory,
// for any Q.
// ---------------------------------------------------------------------------
template <int CPL, typename T>
__device__ inline T pick(const T (&a)[CPL], int c) {  // a[c], c warp-uniform, no local memory
  T x = a[0];
#pragma unroll
  for (int k = 1; k < CPL; ++k)
    if (c == k) x = a[k];
  return x;
}

template <int CPL>
__device__ __forceinline__ void jv_exact_regs(const Smem& s, int N, int Q, int lane) {
  // ucol: u of the column's owner. Each row owns at most one column and a
  // row that owns none has u = 0 until its own phase, so u travels with
  // the ownership and never needs an array of its own.
  float v[CPL], minv[CPL], ucol[CPL];
  int way[CPL], own[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    v[c] = 0.f;
    own[c] = -1;
    ucol[c] = 0.f;
  }

  for (int i = 0; i < N; ++i) {
    int free_col = 0;
#pragma unroll
    for (int c = 0; c < CPL; ++c) free_col |= lane + 32 * c < Q && own[c] < 0;
    if (!((s.valid[i >> 5] >> (i & 31)) & 1u) || !__any_sync(FULL, free_col)) continue;
    unsigned used = 0;  // bit c: column lane + 32c scanned
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      minv[c] = JV_INF;
      way[c] = -1;
    }

    // Dijkstra over reduced costs; the owners do not change until augment.
    // i0 and u_i0 of the next scan come with the test of the found column.
    float u_i = 0.f;
    int j0 = -1, found = 0, i0 = i;
    float u_i0 = 0.f;
    for (int it = 0; found == 0 && it <= Q; ++it) {
      if (j0 >= 0 && lane == (j0 & 31)) used |= 1u << (j0 >> 5);
      const bool row_ok = i0 >= 0 && i0 < N;
      const float* row = s.ben + (row_ok ? i0 : 0) * Q;
      // this lane's first least dm (NaN never wins), then the warp's
      float dl = INFINITY;
      int jl = Q;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int j = lane + 32 * c;
        const bool live = j < Q, un = !((used >> c) & 1u);
        const float r = row_ok && live ? -row[j] : JV_INF;
        const float cur = __fsub_rn(__fsub_rn(r, u_i0), v[c]);
        const bool upd = un && cur < minv[c];
        minv[c] = upd ? cur : minv[c];
        way[c] = upd ? j0 : way[c];
        const float dm = un ? minv[c] : JV_INF;
        const bool take = live && (dm < dl || (jl == Q && dm == dl));
        dl = take ? dm : dl;
        jl = take ? j : jl;
      }
      unsigned kd = jl < Q ? fkey(dl) : NO_KEY;
      int jd = jl;
      warp_argmin(kd, jd, Q);
      const float delta = kd == NO_KEY ? INFINITY : funkey(kd);
      // dual update: owners of used columns and the start row gain delta,
      // used columns' prices drop, unscanned distances shrink
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const bool u = (used >> c) & 1u;
        const float vd = __fsub_rn(v[c], delta), ud = __fadd_rn(ucol[c], delta);
        const float md = __fsub_rn(minv[c], delta);
        v[c] = u ? vd : v[c];
        ucol[c] = u && own[c] >= 0 ? ud : ucol[c];
        minv[c] = u ? minv[c] : md;
      }
      u_i = __fadd_rn(u_i, delta);
      if (jd < Q) {
        i0 = __shfl_sync(FULL, pick<CPL>(own, jd >> 5), jd & 31);
        u_i0 = __shfl_sync(FULL, pick<CPL>(ucol, jd >> 5), jd & 31);
      }
      found = jd >= Q ? 2 : (i0 < 0 ? 1 : 0);
      j0 = jd;
    }

    // augment: shift ownership (and the owner's u) along the predecessor
    // path (lapjv.cpp order), all lanes walking it, the column's lane
    // writing it
    int j = j0, done = 0;
    for (int it = 0; done == 0 && it <= N + 1; ++it) {
      const bool j_ok = j >= 0 && j < Q;
      const int pj = j_ok ? __shfl_sync(FULL, pick<CPL>(way, j >> 5), j & 31) : 0;
      const bool p_ok = pj >= 0 && pj < Q;
      const int prev_owner = p_ok ? __shfl_sync(FULL, pick<CPL>(own, pj >> 5), pj & 31) : 0;
      const float prev_u = p_ok ? __shfl_sync(FULL, pick<CPL>(ucol, pj >> 5), pj & 31) : 0.f;
      if (j_ok && lane == (j & 31)) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          if (c == (j >> 5)) {
            own[c] = pj < 0 ? i : prev_owner;
            ucol[c] = pj < 0 ? u_i : prev_u;
          }
        }
      }
      done = pj < 0;
      j = pj;
    }
  }

  for (int n = lane; n < N; n += 32) s.pobj[n] = -1;
  __syncwarp();
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    if (lane + 32 * c < Q && own[c] >= 0 && own[c] < N) s.pobj[own[c]] = lane + 32 * c;
}

__device__ __forceinline__ void jv_exact_shared(const Smem& s, int N, int Q, int lane) {
  float* v = s.price;
  for (int j = lane; j < Q; j += 32) {
    v[j] = 0.f;
    s.owner[j] = -1;
  }
  for (int n = lane; n < N; n += 32) s.u[n] = 0.f;
  __syncwarp();

  for (int i = 0; i < N; ++i) {
    int free_col = 0;
    for (int j = lane; j < Q; j += 32) free_col |= s.owner[j] < 0;
    if (!((s.valid[i >> 5] >> (i & 31)) & 1u) || !__any_sync(FULL, free_col)) continue;
    for (int j = lane; j < Q; j += 32) {
      s.minv[j] = JV_INF;
      s.used[j] = 0;
      s.way[j] = -1;
    }

    // Dijkstra over reduced costs; the owners do not change until augment
    int j0 = -1, found = 0;
    for (int it = 0; found == 0 && it <= Q; ++it) {
      const int i0 = j0 < 0 ? i : s.owner[j0];
      const bool row_ok = i0 >= 0 && i0 < N;
      const float u_i0 = row_ok ? s.u[i0] : 0.f;
      unsigned kd = NO_KEY;
      int jd = Q;
      for (int j = lane; j < Q; j += 32) {
        if (j == j0) s.used[j] = 1;
        float dm = JV_INF;
        if (!s.used[j]) {
          const float row = row_ok ? -s.ben[i0 * Q + j] : JV_INF;
          const float cur = __fsub_rn(__fsub_rn(row, u_i0), v[j]);
          float mv = s.minv[j];
          if (cur < mv) {
            mv = cur;
            s.minv[j] = cur;
            s.way[j] = j0;
          }
          dm = mv;
        }
        const unsigned k = dm == dm ? fkey(dm) : NO_KEY;
        if (k < kd) {  // columns ascend: the first of equal keys stays
          kd = k;
          jd = j;
        }
      }
      warp_argmin(kd, jd, Q);
      const float delta = kd == NO_KEY ? INFINITY : funkey(kd);
      // dual update: owners of used columns and the start row gain delta,
      // used columns' prices drop, unscanned distances shrink. Each row
      // owns at most one column and row i owns none, so no two lanes
      // write the same u.
      for (int j = lane; j < Q; j += 32) {
        if (s.used[j]) {
          v[j] = __fsub_rn(v[j], delta);
          const int o = s.owner[j];
          if (o >= 0) s.u[o] = __fadd_rn(s.u[o], delta);
        } else {
          s.minv[j] = __fsub_rn(s.minv[j], delta);
        }
      }
      if (lane == 0) s.u[i] = __fadd_rn(s.u[i], delta);
      found = jd >= Q ? 2 : (s.owner[jd] < 0 ? 1 : 0);
      j0 = jd;
      __syncwarp();  // u, used and way are read across lanes next
    }

    // augment: shift ownership along the predecessor path (lapjv.cpp order)
    if (lane == 0) {
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
    __syncwarp();
  }

  for (int n = lane; n < N; n += 32) s.pobj[n] = -1;
  __syncwarp();
  for (int j = lane; j < Q; j += 32) {
    const int o = s.owner[j];
    if (o >= 0 && o < N) s.pobj[o] = j;  // owners are unique
  }
}

// ---------------------------------------------------------------------------
// K1's escalate=False branch (pallas_auction.py:251-275), by warp 0 alone:
// rows the capped auction left unassigned, in row order, take their best
// free column (benefit floored at NEG, first column of the max) if it is
// above NEG/2
// ---------------------------------------------------------------------------
__device__ __forceinline__ void greedy_complete(const Smem& s, int N, int Q, int lane) {
  for (int n = 0; n < N; ++n) {
    if (!((s.bidding[n >> 5] >> (n & 31)) & 1u)) continue;
    unsigned kb = 0;
    int jb = Q;
    for (int j = lane; j < Q; j += 32) {
      const float val = s.owner[j] >= 0 ? NEG : fmaxf(s.ben[n * Q + j], NEG);
      const unsigned k = fkey(val);
      if (k > kb) {  // columns ascend: the first of equal keys stays
        kb = k;
        jb = j;
      }
    }
    const unsigned m = __reduce_max_sync(FULL, kb);
    const int best = static_cast<int>(
        __reduce_min_sync(FULL, static_cast<unsigned>(kb == m ? jb : Q)));
    if (best < Q && funkey(m) > NEG * 0.5f && lane == 0) {
      s.pobj[n] = best;
      s.owner[best] = n;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// K1: forward auction (pallas_auction.py:169-217), then K2 (or the greedy
// completion) if unconverged
// ---------------------------------------------------------------------------
// One block an SM is all a launch needs (B blocks, each a serial chain), so
// the bounds leave ptxas the registers of one block: no spills.
template <int CPL>
__global__ void __launch_bounds__(THREADS, 1)
auction_kernel(const float* __restrict__ benefit, const int* __restrict__ valid,
               const float* __restrict__ eps_arr, int* __restrict__ out, int N, int Q,
               int max_iters, int escalate) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = carve(smem, N, Q);
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int W = words(N);
  const float* ben_g = benefit + static_cast<size_t>(b) * N * Q;
  if ((N * Q) % 4 == 0 && Q % 2 == 0) {  // both ends 16-byte aligned
    const float4* src = reinterpret_cast<const float4*>(ben_g);
    float4* dst = reinterpret_cast<float4*>(s.ben);
    for (int k = tid; k < N * Q / 4; k += THREADS) dst[k] = src[k];
  } else {
    for (int k = tid; k < N * Q; k += THREADS) s.ben[k] = ben_g[k];
  }
  for (int j = tid; j < Q; j += THREADS) {
    s.key[j] = 0ull;
    s.price[j] = 0.f;
    s.owner[j] = -1;
  }
  // rows 32w..32w+31 are one warp's ballot; every row starts bidding if valid
  for (int n0 = warp * 32; n0 < W * 32; n0 += THREADS) {
    const int n = n0 + lane;
    const unsigned vb = __ballot_sync(FULL, n < N && valid[static_cast<size_t>(b) * N + n] != 0);
    if (n < N) s.pobj[n] = -1;
    if (lane == 0) {
      s.valid[n0 >> 5] = vb;
      s.bidding[n0 >> 5] = vb;
    }
  }
  const float eps = eps_arr[b];
  float price_t = 0.f;  // column tid's price and owner (CPL > 0)
  int owner_t = -1;
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    // 1. bids: the r-th bidding row goes to warp r % WARPS (lane l finds
    //    the rank of row 32w + l by a popcount of the lower bits); no
    //    bidder left: converged
    int r = 0;
    for (int w = 0; w < W; ++w) {
      const unsigned m = s.bidding[w];
      const int rank = r + __popc(m & ((1u << lane) - 1u));
      unsigned mine = __ballot_sync(FULL, ((m >> lane) & 1u) && rank % WARPS == warp);
      r += __popc(m);
      for (; mine; mine &= mine - 1) bid_row<CPL>(s, 32 * w + __ffs(mine) - 1, N, Q, eps, lane);
    }
    if (!r) break;  // the same for every thread
    __syncthreads();

    // 2. winners, per column (one column a thread for Q <= 256, its price
    //    and owner kept in registers as well)
    if constexpr (CPL > 0) {
      if (tid < Q) settle(s, tid, N, price_t, owner_t);
    } else {
      for (int j = tid; j < Q; j += THREADS) settle(s, j, N, s.price[j], s.owner[j]);
    }
    __syncthreads();
  }

  unsigned unconverged = 0;
  for (int w = 0; w < W; ++w) unconverged |= s.bidding[w];
  if (unconverged) {  // the same for every thread: no barrier since the last write
    if (warp == 0) {
      if (!escalate)
        greedy_complete(s, N, Q, lane);
      else if constexpr (CPL > 0)
        jv_exact_regs<CPL>(s, N, Q, lane);
      else
        jv_exact_shared(s, N, Q, lane);
    }
    __syncthreads();
  }
  for (int n = tid; n < N; n += THREADS) out[static_cast<size_t>(b) * N + n] = s.pobj[n];
}

template <int CPL>
int launch(const void* benefit, const void* valid, const void* eps, void* out, int B, int N,
           int Q, int max_iters, int escalate, void* stream) {
  // the shared-memory opt-in, once per process, device and instantiation
  constexpr int MAX_DEV = 64;
  static bool opted[MAX_DEV];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= MAX_DEV) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted[dev]) {
    e = cudaFuncSetAttribute(auction_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev] = true;
  }
  auction_kernel<CPL><<<B, THREADS, smem_bytes(N, Q), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(benefit), static_cast<const int*>(valid),
      static_cast<const float*>(eps), static_cast<int*>(out), N, Q, max_iters, escalate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dynamic shared memory of one block; the wrapper rejects shapes above
// the 227 KB a block may use
extern "C" int automoe_auction_smem_bytes(int N, int Q) { return smem_bytes(N, Q); }

// benefit [B,N,Q] f32 (invalid rows 0), valid [B,N] i32, eps [B] f32 →
// out [B,N] i32; escalate != 0: JV for elements unconverged after
// max_iters rounds, else the greedy completion. Launches on `stream`, does
// not synchronise; returns the launch's cudaError_t.
extern "C" int automoe_auction_solve(const void* benefit, const void* valid, const void* eps,
                                     void* out, int B, int N, int Q, int max_iters,
                                     int escalate, void* stream) {
  if (B <= 0 || N < 0 || Q < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* f = Q <= 32 ? launch<1> : Q <= 64 ? launch<2> : Q <= 128 ? launch<4>
          : Q <= 256 ? launch<8> : launch<0>;
  return f(benefit, valid, eps, out, B, N, Q, max_iters, escalate, stream);
}
