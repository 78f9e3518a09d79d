// Mini-grid candidate scorer of the delta engine, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_mini_kernel` of
// graal_tpu/ops/likelihood_pallas.py (built there by `make_mini_grid_scorer`).
// For each of M neighbour slots, a block of C genomes (the base mini-state
// and its 13 candidates) is scored on the neighbour's R x R sub-row grid:
//
//     score[m, c] = sum_{u<v<R} ob[m,u,v] * log_e - exp(log_e)
//     log_e = (same contig ? log_cis : log v_inter) + la_u + la_v - log nfpb
//
// with the per-cell math of the dense scorer (scorer_common.cuh). ob is the
// neighbour's observed grid, la the log accumulation weight, -1e9 on a
// dead row (padding, or inactive), so exp gives 0. The delta of candidate
// c is dll[m, c-1] = score[m, c] - score[m, 0], taken in f64 from the f64
// tile sums and then rounded once: base and candidates differ in few
// cells, and an f32 difference of two f32 sums would lose those cells to
// cancellation. The Rippe parameters are one row per neighbour slot (a
// tempered chain carries its own); an item reads its slot's row once.
//
// Contract on the inputs: ob[m, u, :] and ob[m, :, u] are zero wherever
// candidate 0 (the base) has la[m, 0, u] = -1e9, and la is either -1e9 or
// a log accumulation weight of modest size. The delta engine gives that:
// it folds base activity into B4's keys (core/delta.py obs_keys), so a
// row dead in the base has no window and matches no column.
//
// What bounds it on the card. No design avoids the same-contig power law:
// a logf, a divide and an expf per same-contig pair inside (0, d_max)
// (accurate libm sequences: no --use_fast_math). Until this design the
// kernel also paid ~50 instructions on every other cell of every
// candidate over the whole padded R x R grid, which the TPU kernel's
// premise allowed ("nearly every tile has same-contig pairs": true at
// R <= 1,024 with band 996). At the top tiers (R = 8,192 and 16,384) it
// is false twice over: a mini's live rows (an ascending prefix) fill
// 30-60% of R, so 63-91% of the half tiles are padding; and a same-contig
// pair more than band 996 positions apart is beyond d_max, so past ~17
// tile diagonals a contig run's tiles hold no power-law cell. What is
// left is the band tiles' cells (the same-contig pairs near the diagonal
// and at the junctions of pieces), one read of each live observed tile,
// and a per-item cost.
//
// What the design does about it.
//  - Three classes of (item, candidate), decided per candidate from its
//    own row and column values, the base's la and the item's observed
//    tile, nothing of other neighbours or chunks:
//      empty: all the item's rows, or all its columns, are dead in the
//        candidate and in the base (or past R). Every cell adds exactly 0
//        (E = 0 and, by the contract, ob = 0): the partial is 0.
//      band-free (off-diagonal tiles only): no pair of two live cells
//        of one contig lies inside (0, d_max), and no row or column dead
//        in the candidate has an observed count in the tile. The test is
//        conservative: the [min, max] midpoint of each contig id among
//        the live rows and among the live columns (two ids a side at
//        most, else "band"), every shared id's two intervals d_max or
//        more apart, computed in f32 as the cell test computes |mid_u -
//        mid_v| (rounding is monotone, so every pair passes it too). Every
//        cell is then trans, log E = (log_v + la_u - log nfpb) + la_v and
//        E = rt_u a_v, so the tile's sum is
//        sum_u (log_v + la_u - log nfpb) rowsum(u) + sum_v la_v colsum(v)
//        - (sum_u rt_u)(sum_v a_v): 96 terms in f64, rounded once, from
//        the row and column sums of the staged tile (computed once per
//        item). A dead row with counts must stay cell by cell: the
//        reference rounds each cell's (-1e9 + x), which one f64 product
//        does not reproduce.
//      band: the cell loop below, unchanged.
//    A tile whose inputs are the same in base and candidate gets the same
//    class and the same partial, so it cancels exactly in the delta. A
//    dead row of the candidate that the base has live is, by the
//    engine's contract, without counts, so such a tile's cells add 0 in
//    every class: a score is the same alone and in its batch.
//  - Only live tiles are items. A first kernel finds each neighbour's
//    live extent (1 + its last row live in some candidate; past it every
//    row is dead in every candidate, the base included); blocks build the
//    ticket table from it (schedule.cuh decode_mini_item) and draw the
//    live tiles only, heaviest first (by diagonal offset, so the band
//    tiles come first and the cheap ones fill the tail). The partials of
//    a neighbour's live tiles are a prefix of its partial row
//    (tri_slot), the rest are zero and never written, and the f64
//    reduction sums that prefix in its fixed order: a zero it skips
//    would not have changed the sum.
//  - Elsewhere as before. Only the same-contig pairs inside (0, d_max)
//    of a band item pay the logf, the divide and the expf (circular rows
//    take the circular formula); every other cell has e0 = v_inter and E
//    = (v_inter A_u / nfpb) A_v, with A = exp(la) staged once per row and
//    candidate. A persistent grid (ops/persistent.py sizes it once per
//    process and plans the chunk from the shapes) draws the items from a
//    ticket counter. A block stages the obs rows of its item once and the
//    row and column values of all the chunk's candidates at once, one
//    record per row and column, so a warp reaches every field of its rows
//    at a constant offset from one address per candidate. Shared-memory
//    loads, not arithmetic, set the pace of a trans cell, so in the cell
//    loop each warp takes the candidates in turn, keeps its lanes' two
//    columns in registers for its 4 rows, and reads each row's values (one
//    broadcast load a field) for two cells a lane: a cell costs one load of
//    ob and half a row (cells outside and candidates inside would read the
//    column values once per cell and candidate, and hold 14 accumulators).
//    Each warp reduces its cells per candidate into shared memory; the
//    barrier that opens the next item orders the one sum per candidate of
//    the 8 warp sums. The class test takes a warp per candidate (ballots
//    and shuffles over its 32 rows and 64 columns). The staging is not
//    double-buffered: a second buffer would cost a resident block, and the
//    other resident blocks' work covers one block's loads. 48 registers
//    (16 bytes spilled): 5 blocks an SM.
//  - Index widths. An item, a tile and a partial's slot are ints: at
//    M = 20, R = 16,384 there are 1,315,840 half tiles, and the launch
//    refuses a shape whose half tiles and tickets would pass INT_MAX.
//    Every offset into the (M, R, R) grid, the (M, C, R) vectors and the
//    partials is a size_t product (5.4e9 cells at that shape).
//  - Nothing is accumulated across blocks: one f32 partial per (neighbour,
//    candidate, tile, half), and a third kernel, one warp per candidate,
//    sums them in f64 in a fixed order. A candidate's score depends only on
//    its own inputs, in any batch, whichever block computed it.

#include <climits>

#include <cuda_runtime.h>

#include "scorer_common.cuh"

namespace {

using namespace persistent;

constexpr int CAND_MAX = 14;        // candidates per item (base + 13)
constexpr int MAX_C = 64;           // candidates per neighbour (EM: 14)
constexpr int MIN_BLOCKS = 5;       // resident blocks per SM the registers must allow
constexpr int Q_UNROLL = 2;         // rows of a warp in flight together
constexpr float DEAD_LA = -1e9f;    // la of a dead row
constexpr int EXT_ROWS = THREADS;   // rows a block of the extent pass reads
constexpr int DYN_SMEM_MAX = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

enum TileClass { EMPTY = 0, FREE = 1, BAND = 2 };

// A candidate's values of one row of an item and of one column, as the
// block stages them: one base address per candidate, each field and each
// row of a warp at a constant offset from it.
struct RowVals {
  float mid, cst, la, rt;   // cst: contig length on a circular row, else -1
  int idc;                  // rt: v_inter exp(la) / nfpb
};
struct __align__(16) ColVals {
  float mid, la, a;         // a: exp(la)
  int idc;
};

__device__ __forceinline__ float warp_min(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}
__device__ __forceinline__ double warp_sum_d(double x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(FULL, x, off);
  return x;
}

// The contig ids of a warp's live values (each lane holds up to two): the
// first (lowest lane, first value) and the first other one; *over when a
// third is live.
struct IdPair {
  int a, b;
  bool has_a, has_b, over;
};
__device__ __forceinline__ IdPair id_pair(bool live0, int id0, bool live1, int id1) {
  IdPair p;
  const unsigned m0 = __ballot_sync(FULL, live0), m1 = __ballot_sync(FULL, live1);
  p.has_a = (m0 | m1) != 0;
  p.a = __shfl_sync(FULL, m0 ? id0 : id1, __ffs(m0 ? m0 : (m1 ? m1 : 1u)) - 1);
  const bool o0 = live0 && id0 != p.a, o1 = live1 && id1 != p.a;
  const unsigned n0 = __ballot_sync(FULL, o0), n1 = __ballot_sync(FULL, o1);
  p.has_b = (n0 | n1) != 0;
  p.b = __shfl_sync(FULL, n0 ? id0 : id1, __ffs(n0 ? n0 : (n1 ? n1 : 1u)) - 1);
  if (!p.has_b) p.b = p.a;
  p.over = __any_sync(FULL, (o0 && id0 != p.b) || (o1 && id1 != p.b));
  return p;
}

// [min, max] of the warp's live midpoints of contig id `id`.
__device__ __forceinline__ float2 id_span(bool live0, int id0, float mid0, bool live1, int id1,
                                          float mid1, int id) {
  const bool s0 = live0 && id0 == id, s1 = live1 && id1 == id;
  const float lo = fminf(s0 ? mid0 : INFINITY, s1 ? mid1 : INFINITY);
  const float hi = fmaxf(s0 ? mid0 : -INFINITY, s1 ? mid1 : -INFINITY);
  return make_float2(warp_min(lo), warp_max(hi));
}

// Each neighbour's rows past ext[m, x] - 1 (x its block of EXT_ROWS rows)
// are dead in every candidate: the block's last row live in some candidate,
// plus 1 (0 when none is).
__global__ void __launch_bounds__(THREADS)
ll_mini_extent(const float* __restrict__ la, int C, int R, int* __restrict__ ext) {
  __shared__ int s_max[WARPS];
  const int nbr = blockIdx.y;
  const int r = blockIdx.x * EXT_ROWS + threadIdx.x;
  bool live = false;
  if (r < R)
    for (int c = 0; c < C && !live; ++c) live = la[((size_t)nbr * C + c) * R + r] > DEAD_LA;
  const int v = __reduce_max_sync(FULL, live ? r + 1 : 0);
  if ((threadIdx.x & 31) == 0) s_max[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int mx = 0;
    for (int w = 0; w < WARPS; ++w) mx = max(mx, s_max[w]);
    ext[(size_t)nbr * gridDim.x + blockIdx.x] = mx;
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ll_mini_items(const float* __restrict__ mid,    // (M, C, R) sub-row midpoints (kb)
              const int* __restrict__ idc,      // (M, C, R) contig id
              const float* __restrict__ circ,   // (M, C, R) 1.0 on circular contigs
              const float* __restrict__ stot,   // (M, C, R) contig length (kb)
              const float* __restrict__ la,     // (M, C, R) log accu, -1e9 if dead
              const float* __restrict__ ob,     // (M, R, R) observed grid
              const float* __restrict__ pvec,   // (M, N_PARAMS), one row a mini genome
              const int* __restrict__ ext,      // (M, n_ext) live extents
              float* __restrict__ partial,      // (M, C, n_tri * SLOTS)
              int* __restrict__ next_item,      // ticket counter, 0 at launch
              int* __restrict__ class_counts,   // (3,) (item, candidate) pairs a class, or null
              int M, int C, int R, int n_rb, int n_tri, int n_ext, int cs, int n_chunks) {
  __shared__ float s_ob[ROWS * TILE];
  __shared__ RowVals s_row[CAND_MAX][ROWS];
  __shared__ ColVals s_col[CAND_MAX][TILE];
  __shared__ float s_warp[CAND_MAX][WARPS];  // warp sums of the last item's band candidates
  __shared__ float s_part[CAND_MAX];         // the last item's other partials
  __shared__ int s_class[CAND_MAX];
  __shared__ float s_base_row[ROWS], s_base_col[TILE];   // the base's la
  __shared__ float s_rsum[ROWS], s_csum[4][TILE];        // ob sums: rows; columns by quarters
  __shared__ bool s_rnz[ROWS], s_cnz[4][TILE];           // a count in the row / column
  __shared__ MiniItem s_it;
  __shared__ bool s_stop;
  extern __shared__ int s_dyn[];
  int* s_live = s_dyn;            // (M,) live row blocks of each neighbour
  int* s_dstart = s_dyn + M;      // (n_rb + 1,) first item of each diagonal

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the ticket table: live extents, items a diagonal, their prefix sums
  for (int m = tid; m < M; m += THREADS) s_live[m] = 0;
  __syncthreads();
  for (int e = tid; e < M * n_ext; e += THREADS) {
    const int v = ext[e];
    if (v > 0) atomicMax(&s_live[e / n_ext], v);
  }
  __syncthreads();
  for (int m = tid; m < M; m += THREADS) s_live[m] = (s_live[m] + TILE - 1) / TILE;
  __syncthreads();
  for (int d = tid; d < n_rb; d += THREADS) s_dstart[d + 1] = diag_items(d, s_live, M, n_chunks);
  __syncthreads();
  if (warp == 0) {   // inclusive scan of s_dstart[1 .. n_rb]: lane l a run of seg entries
    const int seg = (n_rb + 31) / 32;
    const int b0 = 1 + lane * seg, b1 = min(n_rb + 1, b0 + seg);
    int run = 0;
    for (int i = b0; i < b1; ++i) run += s_dstart[i];
    int incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    int acc = incl - run;
    for (int i = b0; i < b1; ++i) {
      acc += s_dstart[i];
      s_dstart[i] = acc;
    }
    if (lane == 0) s_dstart[0] = 0;
  }
  __syncthreads();
  const int n_items = s_dstart[n_rb];

  const float* ob_lane = s_ob + warp * TILE + lane;   // this lane's cells of row q: + 8q TILE + 32j
  // the item whose partials wait in shared memory: where its first
  // candidate's partial goes, its candidate count
  size_t last_part = 0;
  int last_nc = 0;

  for (;;) {
    if (tid == 0) {
      const int q = atomicAdd(next_item, 1);
      s_stop = q >= n_items;
      if (!s_stop) s_it = decode_mini_item(q, s_dstart, n_rb, s_live, n_chunks, cs);
    }
    __syncthreads();   // the previous item's readers are done with shared memory
    if (tid < last_nc) {
      float* out = partial + last_part + (size_t)tid * n_tri * SLOTS;
      if (s_class[tid] == BAND) flush_partial(s_warp[tid], out);
      else *out = s_part[tid];
    }
    if (s_stop) break;
    const MiniItem it = s_it;
    const int nbr = it.group;
    const int c0 = it.first;
    const int nc = min(cs, C - c0);
    const bool diag = it.bi == it.bj;
    const RippeCell p(pvec + (size_t)nbr * N_PARAMS);   // this neighbour's parameters
    const int i0 = it.bi * TILE + it.half * ROWS;       // first row of the item
    const int j0 = it.bj * TILE;
    const float* obn = ob + (size_t)nbr * R * R;
    for (int e = tid; e < ROWS * TILE; e += THREADS) {
      const int rg = i0 + e / TILE;
      const int cg = j0 + e % TILE;
      s_ob[e] = (rg < R && cg < R) ? obn[(size_t)rg * R + cg] : 0.0f;
    }
    for (int e = tid; e < nc * ROWS; e += THREADS) {
      const int k = e / ROWS;
      const int u = e - k * ROWS;
      const int rg = i0 + u;
      if (rg < R) {
        const size_t o = ((size_t)nbr * C + c0 + k) * R + rg;
        const float lau = la[o];
        s_row[k][u] = RowVals{mid[o], circ[o] == 1.0f ? stot[o] : -1.0f, lau,
                              p.v_inter * expf(lau - p.log_nfpb), idc[o]};
      }
    }
    for (int e = tid; e < nc * TILE; e += THREADS) {
      const int k = e / TILE;
      const int v = e - k * TILE;
      const int cg = j0 + v;
      if (cg < R) {
        const size_t o = ((size_t)nbr * C + c0 + k) * R + cg;
        const float lav = la[o];
        s_col[k][v] = ColVals{mid[o], lav, expf(lav), idc[o]};
      }
    }
    if (tid < ROWS + TILE) {
      const size_t base = (size_t)nbr * C * R;
      if (tid < ROWS) {
        if (i0 + tid < R) s_base_row[tid] = la[base + i0 + tid];
      } else if (j0 + tid - ROWS < R) {
        s_base_col[tid - ROWS] = la[base + j0 + tid - ROWS];
      }
    }
    __syncthreads();

    if (!diag) {   // the tile's row and column sums, for the closed form
#pragma unroll
      for (int q = 0; q < ROWS_PER_WARP; ++q) {
        const int u = warp + WARPS * q;
        const float x0 = s_ob[u * TILE + lane], x1 = s_ob[u * TILE + lane + 32];
        const float s = warp_sum(x0 + x1);
        const bool nz = __any_sync(FULL, x0 != 0.0f || x1 != 0.0f);
        if (lane == 0) {
          s_rsum[u] = s;
          s_rnz[u] = nz;
        }
      }
      const int v = tid % TILE, part = tid / TILE;
      float s = 0.0f;
      bool nz = false;
      for (int u = part * (ROWS / 4); u < (part + 1) * (ROWS / 4); ++u) {
        const float x = s_ob[u * TILE + v];
        s += x;
        nz |= x != 0.0f;
      }
      s_csum[part][v] = s;
      s_cnz[part][v] = nz;
      __syncthreads();
    }

    // each warp classes candidates of the chunk in turn
    for (int k = warp; k < nc; k += WARPS) {
      const bool r_in = i0 + lane < R;
      const RowVals ru = s_row[k][lane];
      const bool r_live = r_in && ru.la > DEAD_LA;
      const bool r_gone = !r_in || (!r_live && s_base_row[lane] <= DEAD_LA);
      bool c_in[COLS_PER_LANE], c_live[COLS_PER_LANE], c_gone = true;
      ColVals cv[COLS_PER_LANE];
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j) {
        const int v = lane + 32 * j;
        c_in[j] = j0 + v < R;
        cv[j] = s_col[k][v];
        c_live[j] = c_in[j] && cv[j].la > DEAD_LA;
        c_gone &= !c_in[j] || (!c_live[j] && s_base_col[v] <= DEAD_LA);
      }
      int cls = BAND;
      if (__all_sync(FULL, r_gone) || __all_sync(FULL, c_gone)) {
        cls = EMPTY;
        if (lane == 0) s_part[k] = 0.0f;
      } else if (!diag) {
        // a dead row or column with counts in the tile keeps the cell loop
        bool bad = r_in && !r_live && s_rnz[lane];
#pragma unroll
        for (int j = 0; j < COLS_PER_LANE; ++j) {
          const int v = lane + 32 * j;
          bad |= c_in[j] && !c_live[j] &&
                 (s_cnz[0][v] || s_cnz[1][v] || s_cnz[2][v] || s_cnz[3][v]);
        }
        const IdPair rid = id_pair(r_live, ru.idc, false, 0);
        const IdPair cid = id_pair(c_live[0], cv[0].idc, c_live[1], cv[1].idc);
        bool is_free = !__any_sync(FULL, bad) && !rid.over && !cid.over;
        // every id live on both sides: its row and column midpoints d_max apart
        for (int x = 0; is_free && x < 2; ++x) {
          if (!(x == 0 ? rid.has_a : rid.has_b)) continue;
          const int id = x == 0 ? rid.a : rid.b;
          if (!((cid.has_a && cid.a == id) || (cid.has_b && cid.b == id))) continue;
          const float2 rs = id_span(r_live, ru.idc, ru.mid, false, 0, 0.0f, id);
          const float2 cs = id_span(c_live[0], cv[0].idc, cv[0].mid, c_live[1], cv[1].idc,
                                     cv[1].mid, id);
          is_free = (cs.x - rs.y >= p.d_max) || (rs.x - cs.y >= p.d_max);
        }
        if (is_free) {
          cls = FREE;
          double t_ob = 0.0, t_rt = 0.0, t_a = 0.0;
          if (r_in) {
            t_ob = ((double)p.log_v + (double)ru.la - (double)p.log_nfpb) * (double)s_rsum[lane];
            t_rt = ru.rt;
          }
#pragma unroll
          for (int j = 0; j < COLS_PER_LANE; ++j) {
            const int v = lane + 32 * j;
            if (c_in[j]) {
              const float colsum = ((s_csum[0][v] + s_csum[1][v]) + s_csum[2][v]) + s_csum[3][v];
              t_ob += (double)cv[j].la * (double)colsum;
              t_a += cv[j].a;
            }
          }
          t_ob = warp_sum_d(t_ob);
          t_rt = warp_sum_d(t_rt);
          t_a = warp_sum_d(t_a);
          if (lane == 0) s_part[k] = (float)(t_ob - t_rt * t_a);
        }
      }
      if (lane == 0) s_class[k] = cls;
    }
    __syncthreads();

    for (int k = 0; k < nc; ++k) {
      if (s_class[k] != BAND) continue;
      ColVals cv[COLS_PER_LANE];
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j)
        cv[j] = j0 + lane + 32 * j < R ? s_col[k][lane + 32 * j] : ColVals{0.0f, 0.0f, 0.0f, 0};
      const RowVals* rows = &s_row[k][warp];
      float acc = 0.0f;
#pragma unroll Q_UNROLL
      for (int q = 0; q < ROWS_PER_WARP; ++q) {
        const int row_g = i0 + warp + WARPS * q;
        const RowVals* u = rows + WARPS * q;
#pragma unroll
        for (int j = 0; j < COLS_PER_LANE; ++j) {
          const int col_g = j0 + lane + 32 * j;
          if (!(col_g < R && col_g > row_g)) continue;
          const float la_pair = (u->la + cv[j].la) - p.log_nfpb;
          const float s = fabsf(u->mid - cv[j].mid);
          float log_e, e;
          if (u->idc == cv[j].idc && s > 0.0f && s < p.d_max) {
            log_e = p.log_cis(s, u->cst >= 0.0f, u->cst) + la_pair;
            e = expf(log_e);
          } else {   // trans, or same contig outside (0, d_max): e0 = v_inter
            log_e = p.log_v + la_pair;
            e = u->rt * cv[j].a;
          }
          acc += ob_lane[WARPS * TILE * q + 32 * j] * log_e - e;
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) s_warp[k][warp] = acc;
    }
    if (class_counts != nullptr && tid == 0) {
      int n_free = 0, n_band = 0;
      for (int k = 0; k < nc; ++k) {
        n_free += s_class[k] == FREE;
        n_band += s_class[k] == BAND;
      }
      atomicAdd(&class_counts[EMPTY], nc - n_free - n_band);
      atomicAdd(&class_counts[FREE], n_free);
      atomicAdd(&class_counts[BAND], n_band);
    }
    last_part = ((size_t)nbr * C + c0) * n_tri * SLOTS + tri_slot(it.bi, it.bj) * SLOTS + it.half;
    last_nc = nc;
  }
}

// One block per neighbour, one warp per candidate: each candidate's
// partials of the neighbour's live tiles (a prefix) summed in f64 in a
// fixed order, then scores and deltas against candidate 0 (the base).
__global__ void __launch_bounds__(REDUCE_WARPS * 32)
ll_mini_reduce(const float* __restrict__ partial, const int* __restrict__ ext, int n_ext,
               int C, int n_part,
               float* __restrict__ scores,      // (M, C)
               float* __restrict__ dll,         // (M, C - 1)
               int* __restrict__ next_item) {   // reset for the next launch
  __shared__ double s_tot[MAX_C];
  __shared__ int s_n;
  const int nbr = blockIdx.x;
  const int tid = threadIdx.x;
  if (nbr == 0 && tid == 0) *next_item = 0;
  if (tid < 32) {
    int mx = 0;
    for (int x = tid; x < n_ext; x += 32) mx = max(mx, ext[(size_t)nbr * n_ext + x]);
    mx = __reduce_max_sync(FULL, mx);
    const int live = (mx + TILE - 1) / TILE;
    if (tid == 0) s_n = live * (live + 1) / 2 * SLOTS;
  }
  __syncthreads();
  for (int c = tid >> 5; c < C; c += REDUCE_WARPS) {
    const double tot = warp_sum_f64(partial + ((size_t)nbr * C + c) * n_part, s_n);
    if ((tid & 31) == 0) s_tot[c] = tot;
  }
  __syncthreads();
  if (tid < C) {
    scores[(size_t)nbr * C + tid] = (float)s_tot[tid];
    if (tid > 0) dll[(size_t)nbr * (C - 1) + tid - 1] = (float)(s_tot[tid] - s_tot[0]);
  }
}

int row_blocks(int R) { return (R + TILE - 1) / TILE; }

int extent_blocks(int R) { return (R + EXT_ROWS - 1) / EXT_ROWS; }

}  // namespace

extern "C" {

// Upper-triangle tiles of an R x R grid.
int ll_mini_n_tiles(int R) {
  const int n_rb = row_blocks(R);
  return n_rb * (n_rb + 1) / 2;
}

// Live-extent entries a neighbour needs in the (M, ll_mini_n_extents(R))
// int32 scratch.
int ll_mini_n_extents(int R) { return extent_blocks(R); }

int ll_mini_slots() { return SLOTS; }

int ll_mini_max_candidates() { return MAX_C; }

int ll_mini_max_chunk() { return CAND_MAX; }

// Once per process: prefer shared memory over L1 and write the blocks of
// ll_mini_items that stay resident on one SM.
int ll_mini_configure(int* blocks_per_sm) {
  const cudaError_t err = prefer_shared(ll_mini_items);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ll_mini_items,
                                                            THREADS, 0);
}

// Score M x C mini-grid genomes: partial is (M, C, ll_mini_n_tiles(R) *
// ll_mini_slots()) f32 scratch and ext (M, ll_mini_n_extents(R)) int32
// scratch, scores (M, C) and dll (M, C - 1) f32 outputs, next_item a
// device int that is 0 before the launch (and is 0 again after it:
// launches that share it must be ordered on one stream), class_counts
// null or a (3,) int32 that the items add their (item, candidate) pairs of
// each class to (empty, band-free, band; the tiles past a neighbour's live
// extent are drawn by no item and not counted). `cs` candidates per item
// and `grid` persistent blocks come from the caller's plan
// (ops/persistent.py). Mini genome m reads its N_PARAMS parameters at
// pvec + m * N_PARAMS (a shared vector comes broadcast to M rows).
// Launches on `stream`, does not synchronise, returns the cudaError_t of
// the launches.
int ll_mini_score(const float* mid, const int* idc, const float* circ,
                  const float* stot, const float* la, const float* ob,
                  const float* pvec, float* partial, int* ext, float* scores, float* dll,
                  int* next_item, int* class_counts, int M, int C, int R, int cs, int grid,
                  void* stream) {
  if (M <= 0 || M > 65535 || C < 1 || C > MAX_C || R <= 0 || cs < 1 || cs > CAND_MAX ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rb = row_blocks(R);
  const int n_tri = n_rb * (n_rb + 1) / 2;
  const int n_chunks = (C + cs - 1) / cs;
  const int n_ext = extent_blocks(R);
  // items are ints, and the blocks draw tickets up to n_items + grid
  const long long items = (long long)M * n_chunks * n_tri * SLOTS;
  if (items > (long long)INT_MAX - grid) return (int)cudaErrorInvalidValue;
  const size_t dyn = (size_t)(M + n_rb + 1) * sizeof(int);
  if (dyn > (size_t)DYN_SMEM_MAX) return (int)cudaErrorInvalidValue;
  ll_mini_extent<<<dim3(n_ext, M), THREADS, 0, s>>>(la, C, R, ext);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ll_mini_items<<<grid, THREADS, dyn, s>>>(mid, idc, circ, stot, la, ob, pvec, ext, partial,
                                           next_item, class_counts, M, C, R, n_rb, n_tri, n_ext,
                                           cs, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ll_mini_reduce<<<M, REDUCE_WARPS * 32, 0, s>>>(partial, ext, n_ext, C, n_tri * SLOTS, scores,
                                                 dll, next_item);
  return (int)cudaGetLastError();
}

}  // extern "C"
