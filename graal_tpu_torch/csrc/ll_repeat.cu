// Copy-summing dense scorer for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel `_repeat_kernel` of
// graal_tpu/ops/likelihood_pallas.py (built there by
// `make_repeat_pallas_scorer`): the candidate scorer of copy-expanded
// (repeat) tables. For each of B candidate genomes it computes, over the
// data pairs s < t < S,
//
//     E[s,t] = sum_{u in copies(s), v in copies(t)} e0(u,v) * (a_u * a_v / nfpb)
//     pmf    = ob * log E - E - lf[s,t]   (ob > 0),   -E   (ob = 0),
//              0 when E = 0
//
// where a_u is the copy row's accu when its fragment is active and 0
// otherwise, e0 is max(exp(log_cis), v_inter) for a same-contig pair inside
// (0, d_max) (circular variant on circular rows) and v_inter otherwise, and
// lf is the precomputed log(ob!) plane. The whole pmf is evaluated: a cell
// whose copies are all inactive has E = 0 and contributes exactly nothing,
// so no observation constant can be folded out.
//
// What bounds it on the card. No design avoids the same-contig power law:
// a logf, a divide and an expf per same-contig copy pair inside (0, d_max)
// (the accurate libm sequences: no --use_fast_math), and a logf of E per
// data cell summed over more than one copy pair. Everything else is a few
// FP32 operations per cell, and the inputs (obs and lf, 5.3 MB each at
// S = 1,152) are read from device memory about once. At the flagship
// repeat table (S = 1,152 data subs, K = 1,188 copy rows, B = 130) that
// is 86 M data cells per call, most of them trans. There is no product of
// matrices anywhere, so the tensor cores have nothing to do.
//
// What the design does about it.
//  - Copy order. The wrapper hands over the (B, K) copy vectors with rows
//    sorted by data sub, so the copies of data sub s are the contiguous
//    range [copy_start[s], copy_start[s+1]) and the copies of a block of
//    data subs are one contiguous run (the TPU kernel instead pads every
//    sub to mc copy slots and evaluates all mc x mc slot pairs).
//  - Single-copy cells in log space. About 97% of the data subs have one
//    copy. A cell whose row and column each have exactly one copy takes
//    the log-space cell of ll_dense.cu: log E = log e0 + log a_u + log a_v
//    - log nfpb, so it pays no exp -> log round trip, no divide per pair
//    and no logf of E. Only a same-contig pair inside (0, d_max) pays a
//    transcendental: elsewhere e0 = v_inter, E is the product of a per-row
//    factor v_inter a_u / nfpb and a_v, and log E a sum. An inactive copy
//    (a = 0) adds exactly 0 by a branch, never through log 0. The branch
//    is warp-uniform on the row (a warp covers the 64 columns of one row,
//    two a lane), so a duplicated row sends the whole warp to the general
//    path and a duplicated column diverges one lane. Cells with more
//    copies keep the linear-space sum in slot order, with the same per-row
//    factors (no divide per pair). max(exp(raw), v_inter) and max(raw,
//    log v_inter) agree to rounding only: the kernel is held to its plain
//    version at rtol 1e-4.
//  - A persistent grid (schedule.cuh): the wrapper sizes it once per
//    scorer from cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SM
//    count (the shared-memory attribute and the query are not on the
//    launch path), and plans the candidate chunk from the shapes on the
//    host so that the items (half tile, chunk) fill whole rounds of the
//    resident blocks: no tail wave, and the B = 1 nuisance call (342 half
//    tiles) reaches every SM. Blocks draw items from a ticket counter,
//    since an item of same-contig cells costs about ten of trans cells,
//    and heaviest first (tiles by diagonal offset, tile-major).
//  - Copy-dense tables. An item's staged records grow with the copy rows
//    of its 64 data subs (36 bytes a row and candidate at most), so the
//    wrapper caps the chunk at the most candidates whose records fit the
//    card's shared memory (ll_repeat_smem_limit): 13 up to ~450-630 copy
//    rows in a 64-sub block, one candidate up to ~6,000-8,000.
//  - No barrier per candidate. A block stages its item's obs and lf rows
//    and the copy vectors of all the chunk's candidates in shared memory
//    at once, as one record per copy row and column with the per-row
//    factors (log a, a / nfpb, the circular flag folded into the contig
//    length), so a warp reaches every field at a constant offset from one
//    address: one barrier after the staging and one before the next
//    item's. Shared-memory loads, not arithmetic, set the pace of a trans
//    cell, so a row's record, read by the whole warp at once, serves two
//    cells a lane. Each warp reduces its cells per candidate into shared
//    memory; the barrier that opens the next item also orders the one sum
//    per candidate of the 8 warp sums. The staging is not double-buffered:
//    a second buffer would halve the resident blocks, and the other
//    resident blocks' work covers one block's loads. 62 registers, no
//    spills: 4 blocks an SM (48 registers spilled).
//  - Nothing is accumulated across blocks: one f32 partial per (candidate,
//    tile, half), and a second kernel, one warp per candidate, sums them
//    in f64 in a fixed order. No float atomics, so a candidate's score is
//    bit-identical alone and in any batch, whichever block computed it.

#include <cuda_runtime.h>

#include "scorer_common.cuh"

namespace {

using namespace persistent;

constexpr int CAND_MAX = 13;        // candidates per item (EM batches are 13 m)
constexpr int MIN_BLOCKS = 4;       // resident blocks per SM the registers must allow
constexpr int Q_UNROLL = 4;         // rows of a warp in flight together
// A candidate's values of one copy row of an item and of one copy column,
// as the block stages them: each field at a constant offset from the
// record's address.
struct CopyRow {
  float mid, cst, la, ap;   // cst: contig length on a circular row, else -1
  int idc;                  // la: log a (a > 0); ap: a / nfpb
};
struct __align__(16) CopyCol {
  float mid, la, a;
  int idc;
};

// Dynamic shared memory of one block (bytes): the obs and lf rows of an
// item, the copy ranges of its rows and columns, and the copy records of
// `cs` candidates (columns first, 16-byte aligned).
__host__ __device__ __forceinline__ int cols_offset() {
  return (2 * ROWS * TILE + (ROWS + 1) + (TILE + 1) + 3) / 4 * 16;
}
__host__ __device__ __forceinline__ int smem_bytes(int cs, int max_hblk, int max_blk) {
  return cols_offset() + cs * (max_blk * (int)sizeof(CopyCol) + max_hblk * (int)sizeof(CopyRow));
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ll_repeat_items(const float* __restrict__ mid,   // (B, K) copy-row midpoints (kb), copy order
                const int* __restrict__ idc,     // (B, K) contig id
                const float* __restrict__ circ,  // (B, K) 1.0 on circular contigs
                const float* __restrict__ stot,  // (B, K) contig length (kb)
                const float* __restrict__ a,     // (B, K) accu if active, else 0
                const int* __restrict__ copy_start,  // (S + 1,) copy ranges
                const float* __restrict__ obs,   // (S, S) observed counts
                const float* __restrict__ lf,    // (S, S) log(ob!)
                const float* __restrict__ pvec,  // (N_PARAMS,)
                float nfpb, float* __restrict__ partial,  // (B, n_tri * SLOTS)
                int* __restrict__ next_item,     // ticket counter, 0 at launch
                int B, int S, int K, int n_rb, int n_tri, int cs, int n_chunks, int n_items,
                int max_hblk, int max_blk) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  float* s_obs = reinterpret_cast<float*>(smem);   // (ROWS, TILE)
  float* s_lf = s_obs + ROWS * TILE;                // (ROWS, TILE)
  int* s_rs = reinterpret_cast<int*>(s_lf + ROWS * TILE);   // (ROWS + 1,)
  int* s_cs = s_rs + ROWS + 1;                      // (TILE + 1,)
  CopyCol* s_cols = reinterpret_cast<CopyCol*>(smem + cols_offset());   // (cs, max_blk)
  CopyRow* s_rows = reinterpret_cast<CopyRow*>(s_cols + cs * max_blk);  // (cs, max_hblk)
  __shared__ float s_warp[CAND_MAX][WARPS];         // warp sums of the last item
  __shared__ int s_item;

  const RippeCell p(pvec);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // this lane's cells of row q: + 8q TILE + 32j; the copy ranges of its rows: + 8q
  const float* obs_lane = s_obs + warp * TILE + lane;
  const float* lf_lane = s_lf + warp * TILE + lane;
  const int* rs_warp = s_rs + warp;
  const int n_part = n_tri * SLOTS;
  // the item whose warp sums wait in s_warp: its first candidate, its
  // candidate count and its partial slot
  int last_b0 = 0, last_nb = 0, last_slot = 0;

  for (;;) {
    if (tid == 0) s_item = atomicAdd(next_item, 1);
    __syncthreads();   // the previous item's readers are done with shared memory
    const int item = s_item;
    if (tid < last_nb)
      flush_partial(s_warp[tid], partial + (size_t)(last_b0 + tid) * n_part + last_slot);
    if (item >= n_items) break;
    const Item it = decode_item(item, 1, n_chunks, cs);
    const int half = it.half;
    const int t = it.tile;
    const int b0 = it.first;
    const int nb = min(cs, B - b0);
    int bi, bj;
    band_coords(t, n_rb, &bi, &bj);
    const int i0 = bi * TILE + half * ROWS;         // first row of the item
    const int j0 = bj * TILE;
    const int r_base = copy_start[min(i0, S)];
    const int n_r = copy_start[min(i0 + ROWS, S)] - r_base;
    const int c_base = copy_start[j0];
    const int n_c = copy_start[min(j0 + TILE, S)] - c_base;

    for (int e = tid; e < ROWS * TILE; e += THREADS) {
      const int rg = i0 + e / TILE;
      const int cg = j0 + e % TILE;
      const bool ok = rg < S && cg < S;
      const size_t o = (size_t)rg * S + cg;
      s_obs[e] = ok ? obs[o] : 0.0f;
      s_lf[e] = ok ? lf[o] : 0.0f;
    }
    if (tid <= ROWS) s_rs[tid] = copy_start[min(i0 + tid, S)] - r_base;
    if (tid <= TILE) s_cs[tid] = copy_start[min(j0 + tid, S)] - c_base;
    for (int e = tid; e < nb * n_r; e += THREADS) {
      const int k = e / n_r;
      const int u = e - k * n_r;
      const size_t o = (size_t)(b0 + k) * K + r_base + u;
      const float au = a[o];
      s_rows[k * max_hblk + u] = CopyRow{mid[o], circ[o] == 1.0f ? stot[o] : -1.0f,
                                         au > 0.0f ? logf(au) : 0.0f, au / nfpb, idc[o]};
    }
    for (int e = tid; e < nb * n_c; e += THREADS) {
      const int k = e / n_c;
      const int v = e - k * n_c;
      const size_t o = (size_t)(b0 + k) * K + c_base + v;
      const float av = a[o];
      s_cols[k * max_blk + v] = CopyCol{mid[o], av > 0.0f ? logf(av) : 0.0f, av, idc[o]};
    }
    __syncthreads();

    // this lane's columns: their copy ranges, and their copies' values
    // when they have exactly one
    int v0[COLS_PER_LANE], nv[COLS_PER_LANE];
#pragma unroll
    for (int j = 0; j < COLS_PER_LANE; ++j) {
      const bool ok = j0 + lane + 32 * j < S;
      v0[j] = ok ? s_cs[lane + 32 * j] : 0;
      nv[j] = ok ? s_cs[lane + 32 * j + 1] - v0[j] : 0;
    }
    for (int k = 0; k < nb; ++k) {
      const CopyRow* rows = s_rows + k * max_hblk;
      const CopyCol* cols = s_cols + k * max_blk;
      CopyCol cv[COLS_PER_LANE];
#pragma unroll
      for (int j = 0; j < COLS_PER_LANE; ++j)
        cv[j] = nv[j] == 1 ? cols[v0[j]] : CopyCol{0.0f, 0.0f, 0.0f, 0};
      float acc = 0.0f;
#pragma unroll Q_UNROLL
      for (int q = 0; q < ROWS_PER_WARP; ++q) {
        const int row_g = i0 + warp + WARPS * q;
        const int u0 = rs_warp[WARPS * q];
        const int nu = rs_warp[WARPS * q + 1] - u0;
        const CopyRow* u = rows + u0;
#pragma unroll
        for (int j = 0; j < COLS_PER_LANE; ++j) {
          if (!(nv[j] > 0 && j0 + lane + 32 * j > row_g)) continue;   // nv = 0: beyond S
          const float ob = obs_lane[WARPS * TILE * q + 32 * j];
          if (nu == 1 && nv[j] == 1) {
            // log-space single-copy cell
            if (!(u->ap > 0.0f && cv[j].a > 0.0f)) continue;   // an inactive copy: E = 0
            const float la_pair = (u->la + cv[j].la) - p.log_nfpb;
            const float s = fabsf(u->mid - cv[j].mid);
            float log_e, e;
            if (u->idc == cv[j].idc && s > 0.0f && s < p.d_max) {
              log_e = p.log_cis(s, u->cst >= 0.0f, u->cst) + la_pair;
              e = expf(log_e);
            } else {   // trans, or same contig outside (0, d_max): e0 = v_inter
              log_e = p.log_v + la_pair;
              e = (p.v_inter * u->ap) * cv[j].a;
            }
            acc += ob > 0.0f ? ob * log_e - e - lf_lane[WARPS * TILE * q + 32 * j] : -e;
          } else {
            // general cell: the linear-space sum over its copy pairs, in slot order
            float e_tot = 0.0f;
            for (int ui = 0; ui < nu; ++ui) {
              const CopyRow r = u[ui];
              if (!(r.ap > 0.0f)) continue;
              const float tu = p.v_inter * r.ap;
              for (int vi = v0[j]; vi < v0[j] + nv[j]; ++vi) {
                const CopyCol v = cols[vi];
                if (!(v.a > 0.0f)) continue;
                const float s = fabsf(r.mid - v.mid);
                const float f = (r.idc == v.idc && s > 0.0f && s < p.d_max)
                    ? p.cis(s, r.cst >= 0.0f, r.cst) * r.ap
                    : tu;
                e_tot += f * v.a;
              }
            }
            if (e_tot > 0.0f)
              acc += ob > 0.0f ? ob * logf(e_tot) - e_tot - lf_lane[WARPS * TILE * q + 32 * j]
                               : -e_tot;
          }
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) s_warp[k][warp] = acc;
    }
    last_b0 = b0;
    last_nb = nb;
    last_slot = t * SLOTS + half;
  }
}

// One warp per candidate: its partials summed in f64 in a fixed order.
__global__ void __launch_bounds__(REDUCE_WARPS * 32)
ll_repeat_reduce(const float* __restrict__ partial, int B, int n_part, float* __restrict__ out,
                 int* __restrict__ next_item) {   // reset for the next launch
  const int b = blockIdx.x * REDUCE_WARPS + (threadIdx.x >> 5);
  if (blockIdx.x == 0 && threadIdx.x == 0) *next_item = 0;
  if (b >= B) return;
  const double tot = warp_sum_f64(partial + (size_t)b * n_part, n_part);
  if ((threadIdx.x & 31) == 0) out[b] = (float)tot;
}

int row_blocks(int S) { return (S + TILE - 1) / TILE; }

}  // namespace

extern "C" {

// Upper-triangle tiles of the data grid of S subs.
int ll_repeat_n_tiles(int S) {
  const int n_rb = row_blocks(S);
  return n_rb * (n_rb + 1) / 2;
}

int ll_repeat_slots() { return SLOTS; }

int ll_repeat_max_chunk() { return CAND_MAX; }

// Dynamic shared memory (bytes) of a launch with `cs` candidates per item,
// when the largest block of 32 data subs holds max_hblk copy rows and the
// largest block of 64 holds max_blk.
int ll_repeat_smem_bytes(int cs, int max_hblk, int max_blk) {
  return smem_bytes(cs, max_hblk, max_blk);
}

// The dynamic shared memory (bytes) a block of ll_repeat_items may have on
// `device`: the opt-in limit per block less the kernel's static shared
// memory. A negative cudaError_t when the device cannot be asked.
int ll_repeat_smem_limit(int device) {
  int optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, ll_repeat_items);
  if (err != cudaSuccess) return -(int)err;
  return optin - (int)attr.sharedSizeBytes;
}

// Once per scorer, not per launch: allow `smem` bytes of dynamic shared
// memory (raised only when above what was already allowed), prefer shared
// memory over L1, and write the blocks of ll_repeat_items that stay
// resident on one SM at that size.
int ll_repeat_configure(int smem, int* blocks_per_sm) {
  static int allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        ll_repeat_items, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const cudaError_t err = prefer_shared(ll_repeat_items);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, ll_repeat_items,
                                                            THREADS, smem);
}

// Score B candidates: the (B, K) copy vectors are in copy order (the
// copies of data sub s at [copy_start[s], copy_start[s+1])), partial is
// (B, ll_repeat_n_tiles(S) * ll_repeat_slots()) f32 scratch, out is (B,) f32,
// next_item a device int that is 0 before the launch (and is 0 again after
// it: launches that share it must be ordered on one stream). `cs`
// candidates per item and `grid` persistent blocks come from the caller's
// plan (ops/persistent.py), after ll_repeat_configure allowed the shared
// memory of at least `cs` candidates. Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launches.
int ll_repeat_score(const float* mid, const int* idc, const float* circ,
                    const float* stot, const float* a, const int* copy_start,
                    const float* obs, const float* lf, const float* pvec,
                    float nfpb, float* partial, float* out, int* next_item, int B, int S,
                    int K, int max_hblk, int max_blk, int cs, int grid, void* stream) {
  if (B <= 0 || S <= 0 || K < S || max_hblk <= 0 || max_blk <= 0 || cs < 1 ||
      cs > CAND_MAX || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rb = row_blocks(S);
  const int n_tri = n_rb * (n_rb + 1) / 2;
  const int n_chunks = (B + cs - 1) / cs;
  const int n_items = n_chunks * n_tri * SLOTS;
  ll_repeat_items<<<grid, THREADS, ll_repeat_smem_bytes(cs, max_hblk, max_blk), s>>>(
      mid, idc, circ, stot, a, copy_start, obs, lf, pvec, nfpb, partial, next_item, B, S, K,
      n_rb, n_tri, cs, n_chunks, n_items, max_hblk, max_blk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ll_repeat_reduce<<<(B + REDUCE_WARPS - 1) / REDUCE_WARPS, REDUCE_WARPS * 32, 0, s>>>(
      partial, B, n_tri * SLOTS, out, next_item);
  return (int)cudaGetLastError();
}

}  // extern "C"
