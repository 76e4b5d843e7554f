// B4 (GroupNorm + SiLU, and its statistics alone) and B10's backward
// (LayerNorm backward) for Hopper: the reduction that crosses blocks is done
// inside a thread-block cluster through distributed shared memory (DSMEM), so
// that a call is one launch (GroupNorm two where its map's clusters do not
// fit the card at once) instead of partial rows and a second pass.
//
// B4 replaces the Pallas kernel `_group_norm_pallas_impl` / `_gn_kernel`
// (paddlemix_tpu/ops/norms.py), whose sequential grid carried per-channel sums
// from step to step. GroupNorm does a few flops an element, so the bytes
// bound it: read x once, write y once. A cluster owns one (batch, channel
// slab) pair; a slab holds whole groups and its row is a multiple of 16 bytes
// (so that TMA and 16-byte loads can take it). Two forms, which the plan
// (`gn_plan`, mirrored by ops/norms.py `group_norm_plan`) picks:
//   - resident (one launch): each block TMA-loads its run of the slab's rows
//     into shared memory once, sums x and x^2 per channel in fp32, the sums
//     go to groups and then across the cluster through DSMEM in rank order,
//     every block forms each group's mean and rstd (E[x^2] - E[x]^2 clamped
//     at 0, as the plain version `_group_moments` takes it), and applies the
//     affine and the optional SiLU to the tile it holds: x is read from
//     device memory once.
//   - re-read (two launches), where the map's clusters do not all fit the
//     card at once (GN_CAPACITY: a second wave would wait for the first to
//     finish) or its rows are no multiple of 16 bytes: the statistics kernel
//     (the same walk, streaming its rows from device memory), then an apply
//     kernel that reads x again, a block over whole rows where they fit.
// `group_norm_stats` (B5's statistics) is the statistics kernel alone: it
// writes (mean, rstd) as (B, groups) fp32.
//
// B10's backward replaces `_layer_norm_pallas_bwd` / `_ln_bwd_kernel`:
//   dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat = g w,
//   dw = sum over rows of g xhat, db = sum of g,
// in fp32; dx in x's dtype, dw and db in the weight's. It reads x and g once
// and writes dx once: the bytes bound it. A warp owns one row at a time (at
// most 2,048 wide); the next rows' x and g are in flight in a per-warp
// cp.async ring (each lane copies and later reads its own 16-byte chunks, so
// no barrier guards the ring); the row's moments and the two sums of dx are
// warp shuffles. Rows up to 1,280 wide (five 16-byte loads a lane) are held
// in registers, x, g and w beside dw and db. Wider rows (EVA's 2,048-wide
// sub-LN `ffn_ln`: 64 elements a lane) would need five arrays of 64 floats
// a lane, so the wide form holds only dw and db in registers: w sits in
// shared memory in lane order (each lane reads its own columns, no bank
// conflict), and the row is read from its ring slot (or, unaligned, from
// device memory through L1) once a pass, four passes (mean, variance, the
// two sums, dx), none of which goes back to device memory. The wide form runs
// one block an SM (a ring of up to 128 KB), several clusters of 4 as the
// card holds at once. dw and db build up in registers and
// are reduced across the block's warps in shared memory, then across the
// cluster through DSMEM, each rank a slice of the columns. With one cluster
// (up to 1,024 rows) that slice is the result. With several, each cluster
// writes one fp32 partial row, and for each slice the block that takes the
// last ticket (after a __threadfence) sums the partial rows in cluster order,
// writes dw and db, and resets its ticket, so that the next launch, or the
// next replay of a CUDA graph, starts from 0. Every sum runs in a fixed
// order, so two launches are bit-identical. The tickets are one buffer a
// device: two of these launches must not run at once on two streams.
//
// B11's forward (RMSNorm), B12 (adaLN), B13 (fused adaLN + gated residual)
// and B10's forward (LayerNorm) are one family of row kernels. B11 replaces
// `_rms_norm_pallas_fwd_impl` / `_rms_fwd_kernel`: y = x rsqrt(mean(x^2) +
// eps) w, in fp32, rounded once to x's dtype. B12 replaces
// `_adaln_pallas_fwd_impl` / `_adaln_kernel`: LN(x) (1 + scale[b]) + shift[b]
// over x (B, S, H), the variance two-pass (about the mean) in fp32, rounded
// once. B13 replaces `_fused_adaln_residual_pallas` /
// `_fused_adaln_residual_kernel`: resi = residual + gate[b] x in fp32, then
// B12's norm over that unrounded sum; resi and y rounded once each. B10's
// forward replaces `_layer_norm_pallas_fwd_impl` / `_ln_fwd_kernel`: (x -
// mean) rsqrt(var + eps) w + b, two-pass, in fp32, rounded once; x read in
// place at its row stride. All do a few flops an element, so the bytes bound
// them: each input row read once, each output row written once, and every
// per-column vector loaded once a block (B11's weight and B12's 1 + scale
// and shift kept in registers for all of the block's rows). A thread holds
// 16-byte chunks of a row where every pointer, row stride and width allows
// it, else single elements (the same kernels). Plans (`rms_plan`, `ada_plan`,
// `norm_plan`, mirrored by ops/norms.py `rms_norm_plan`, `adaln_plan`,
// `fused_adaln_plan` and `layer_norm_plan`):
//   - few rows (B11's decode row and T5's 77, B12's and B13's 308 context
//     rows, B10's 77, 256 and 577 tower rows): a block a row, so the grid
//     spreads over the SMs. Each thread issues all of its loads of the row
//     and of the per-column vectors before it uses any: one memory round
//     trip. The moments are warp shuffles, then shared-memory exchanges
//     between the warps (B11: the sums of squares; B12: each warp's sum,
//     mean and squared deviations from that mean, combined; B13 and B10: the
//     sums, then the squared deviations from the mean, two-pass); no cluster
//     (a cluster's barrier chain costs more than such a row). B13 stores
//     resi as soon as it is formed.
//   - many rows: B11 (608 and 4,096 rows) and B12 (8,192 image rows) run
//     persistent blocks, each a run of rows (B12's within one batch element,
//     so one modulation row serves them all). B11's block takes a row across
//     its warps; B12's warp takes its own rows, the moments warp shuffles with
//     no barrier. The next row's loads are issued into a second set of
//     registers before the current row reduces. B13's 8,192 image rows stay
//     a block a row (8,192 small blocks), and B10's CLIP rows (50,432 and
//     19,712, at most 4 chunks a lane) run a warp a row in blocks of 4 warps
//     on rows of one batch element, the affine read after the moments: small
//     blocks of few registers, so that an SM holds many rows in flight. (A
//     per-thread cp.async ring of up to 6 rows in shared memory, a deeper
//     register ring, and for B13 and B10 a per-warp ring of 1-D TMA bulk
//     copies, persistent or two blocks an SM, several rows a block or a warp
//     and bounded registers were measured slower on the card; PERF.md §6.)
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; libcuda itself is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int SMS = 132;                // an H100 SXM's multiprocessors: the plans' target
constexpr int MAX_CLUSTER = 16;         // Hopper's largest (non-portable) cluster
constexpr int SMEM_MAX = 231424;        // dynamic shared memory a block may ask for: 227 KB
                                        // less 1 KB for the kernels' static shared memory
constexpr int PLAN_MISMATCH = 20000;    // a launch whose plan is not the library's own
constexpr int TENSOR_MAP_ERROR = 10000; // + the CUresult of a tensor map libcuda refused

// ------------------------------------------------------------------ plans
// GroupNorm. Slab: the fewest whole groups whose row is a multiple of 16 bytes
// and at least 64 (two sectors), or the widest such below 64 where the groups
// allow no more; without a 16-byte slab (C * esize no multiple of 16) the
// fewest groups of at least 64 bytes, read one element at a time.
constexpr int GN_SLAB_BYTES = 64;         // a slab's row at least
constexpr int GN_TARGET_BLOCKS = 2 * SMS;  // blocks the cluster size aims at
constexpr int GN_MIN_ROWS = 32;            // rows a block at least
constexpr int GN_TILE_MAX = 200 * 1024;    // a resident tile's bytes at most (+ scratch)
constexpr int GN_THREADS = 256;            // resident and apply blocks
constexpr int GN_STATS_THREADS = 512;      // statistics blocks
constexpr int GN_UNROLL = 8;               // rows in flight a thread (statistics, apply)
constexpr int GN_BOX_ROWS = 256;           // TMA's largest box
constexpr int GN_HEAD = 512;               // mbarriers: one a box, at most 64 boxes a tile

struct GnPlan {
  int form;           // 0 resident (one launch), 1 re-read (statistics + apply)
  int slab;           // channels a cluster owns
  int vec;            // elements a load
  int cluster;        // blocks a cluster
  int rows;           // rows a block holds (resident) or walks (statistics)
  int threads;        // threads a resident or statistics block
  int box;            // rows a TMA box (resident)
  int smem;           // dynamic shared memory a resident or statistics block
  int apply_rows;     // rows a block of the apply kernel (re-read)
  int apply_span;     // its columns: whole slabs, whole rows where they fit
};
constexpr int GN_PLAN_INTS = 10;

int cdiv(long long a, long long b) { return int((a + b - 1) / b); }

int gn_slab(int c, int groups, int es) {
  const int cpg = c / groups;
  int s16 = 0;
  for (int k = 1; k <= groups; ++k) {
    if (groups % k) continue;
    const int s = cpg * k;
    if ((s * es) % 16 == 0) {
      if (s * es >= GN_SLAB_BYTES) return s;
      s16 = s;
    }
  }
  if (s16) return s16;
  for (int k = 1; k <= groups; ++k)
    if (groups % k == 0 && cpg * k * es >= GN_SLAB_BYTES) return cpg * k;
  return c;
}

// Bytes of a block's dynamic shared memory: GN_HEAD bytes of mbarriers (one a
// TMA box; the tile starts 128-byte aligned), the tile, and the sums' scratch:
// each warp's channel sums of x and x^2, the slab's group sums, their totals,
// means and rstds.
int gn_smem(int tile_bytes, int threads, int slab, int cpg) {
  return GN_HEAD + tile_bytes + 4 * ((threads / 32) * 2 * slab + 6 * (slab / cpg));
}

// Clusters of the resident kernel (256 threads) that an H100 SXM runs at once,
// by cluster size 1, 2, 4, 8, 16 and a block's shared memory up to 30, 60,
// 100 KB or more (cudaOccupancyMaxActiveClusters; `norms_max_clusters`).
constexpr int GN_CAPACITY[5][4] = {{528, 396, 264, 132}, {264, 198, 132, 66}, {124, 92, 62, 30},
                                   {62, 45, 30, 15}, {28, 21, 14, 7}};

// The same for the statistics kernel (512 threads, at most 100 KB).
constexpr int GN_STATS_CAPACITY[5] = {264, 132, 62, 30, 14};

int log2_of(int cl) {
  int i = 0;
  while ((1 << i) < cl) ++i;
  return i;
}

int gn_capacity(int cl, int smem) {
  return GN_CAPACITY[log2_of(cl)][smem <= 30 * 1024 ? 0 : smem <= 60 * 1024 ? 1 : smem <= 100 * 1024 ? 2 : 3];
}

// The plan of a (b, n, c) map in `groups` groups, esize bytes an element;
// `aligned`: x and y start 16-byte aligned; `stats`: the statistics alone.
// Cluster sizes are powers of two: the largest up to the GN_TARGET_BLOCKS
// spread (and GN_MIN_ROWS rows a block). The resident form where a cluster
// size gives a tile of at most GN_TILE_MAX and every cluster runs at once
// (GN_CAPACITY), the largest such; else the re-read form. The statistics take
// the largest cluster size up to that spread whose clusters all run at once
// (GN_STATS_CAPACITY), and the apply kernel spans of whole rows up to
// GN_THREADS loads. Returns false where no plan takes the shape (a slab wider
// than 256 loads).
bool gn_plan(int b, int n, int c, int groups, int es, bool aligned, bool stats, GnPlan* p) {
  const int slab = gn_slab(c, groups, es);
  const int vec = aligned && (slab * es) % 16 == 0 ? 16 / es : 1;
  const int nv = slab / vec;
  if (nv > GN_STATS_THREADS / 2) return false;
  const int cpg = c / groups;
  const long long clusters = (long long)b * (c / slab);
  const int most = n < GN_MIN_ROWS * MAX_CLUSTER ? (n + GN_MIN_ROWS - 1) / GN_MIN_ROWS : MAX_CLUSTER;
  const long long spread = (GN_TARGET_BLOCKS + clusters - 1) / clusters;
  int top = 1;
  while (top * 2 <= most && top < spread) top *= 2;
  p->slab = slab;
  p->vec = vec;
  int span = slab;
  for (int k = 2; k <= c / slab; ++k)
    if ((c / slab) % k == 0 && slab * k / vec <= GN_THREADS) span = slab * k;
  p->apply_span = span;
  p->apply_rows = (GN_THREADS / (span / vec)) * GN_UNROLL;
  if (!stats && vec > 1 && slab <= GN_BOX_ROWS)
    for (int cl = top; cl >= 1; cl /= 2) {
      const int rows = cdiv(n, cl);
      const int box = rows < GN_BOX_ROWS ? (rows + 7) / 8 * 8 : GN_BOX_ROWS;
      const int tile = cdiv(rows, box) * box * slab * es;
      const int smem = gn_smem(tile, GN_THREADS, slab, cpg);
      if (tile <= GN_TILE_MAX && clusters <= gn_capacity(cl, smem)) {
        p->form = 0;
        p->cluster = cl;
        p->rows = rows;
        p->threads = GN_THREADS;
        p->box = box;
        p->smem = smem;
        return true;
      }
    }
  int cl = top;  // the statistics: the largest cluster whose clusters all run at once
  while (cl > 1 && clusters > GN_STATS_CAPACITY[log2_of(cl)]) cl /= 2;
  p->form = 1;
  p->cluster = cl;
  p->rows = cdiv(n, cl);
  p->threads = GN_STATS_THREADS;
  p->box = 0;
  p->smem = gn_smem(0, p->threads, slab, cpg);
  return true;
}

// LayerNorm backward.
constexpr int LN_WARPS = 8;                // warps a block
constexpr int LN_RING_BYTES = 96 * 1024;   // a block's ring of rows in flight
constexpr int LN_SINGLE_ROWS = 1024;       // rows one cluster takes alone
constexpr int LN_CLUSTER = 4;              // blocks a cluster, several clusters
// Blocks, several clusters: two an SM, in as many clusters of 4 as an H100
// SXM runs at once (cudaOccupancyMaxActiveClusters: 62), rounded down to 60.
constexpr int LN_BLOCKS = 60 * LN_CLUSTER;
constexpr int LN_MAX_WIDTH = 2048;         // EVA's sub-LN rows (ffn_ln); the backward's limit
constexpr int LN_HOLD_EPL = 40;            // a lane's share held in registers at most (1,280)
constexpr int LN_WIDE_EPL = 64;            // the wide form's share (2,048 / 32)
constexpr int LN_WIDE_RING_BYTES = 128 * 1024;  // the wide form's ring, one block an SM
constexpr int LN_WIDE_CLUSTER = 8;         // one cluster's blocks at most, wide form (portable)
// Wide form, several clusters: one block an SM, so half the clusters of 4
// that two blocks an SM give (62 / 2, rounded down).
constexpr int LN_WIDE_BLOCKS = 30 * LN_CLUSTER;
constexpr int LN_GATHER = 16;              // partial rows in flight a thread, last block

struct LnPlan {
  int vec;       // elements a load (16 bytes, or 1)
  int epl;       // elements a lane takes of a row (8 ... 40 held, 64 wide)
  int stages;    // rows of the ring a warp (0: no ring, one element a load)
  int warps;     // warps a block
  int cluster;   // blocks a cluster
  int clusters;  // clusters
  int rpw;       // rows a warp
  int smem;      // dynamic shared memory a block
};
constexpr int LN_PLAN_INTS = 8;

int ln_row_bytes(int h, int es) { return (h * es + 15) / 16 * 16; }

// `aligned`: x, g and dx start 16-byte aligned and both row strides are
// multiples of 16 bytes.
bool ln_plan(int rows, int h, int es, bool aligned, LnPlan* p) {
  if (h < 1 || h > LN_MAX_WIDTH || rows < 1) return false;
  const int vec = aligned && (h * es) % 16 == 0 ? 16 / es : 1;
  p->vec = vec;
  p->warps = LN_WARPS;
  bool wide;
  if (vec > 1) {
    const int per_lane = cdiv(h, 32 * vec) * vec;
    p->epl = (per_lane + 7) / 8 * 8;
    wide = p->epl > LN_HOLD_EPL;
    if (wide) p->epl = LN_WIDE_EPL;
    const int lo = wide ? 1 : 2;
    int st = (wide ? LN_WIDE_RING_BYTES : LN_RING_BYTES) / (LN_WARPS * 2 * ln_row_bytes(h, es));
    p->stages = st < lo ? lo : st > 4 ? 4 : st;
  } else {
    wide = h > LN_HOLD_EPL * 32;
    p->epl = wide ? LN_WIDE_EPL : LN_HOLD_EPL;
    p->stages = 0;
  }
  const int cap = wide ? LN_WIDE_CLUSTER : MAX_CLUSTER;
  if (rows <= LN_SINGLE_ROWS) {
    const int blocks = cdiv(rows, LN_WARPS);
    p->cluster = blocks < cap ? blocks : cap;
    p->clusters = 1;
  } else {
    p->cluster = LN_CLUSTER;
    p->clusters = (wide ? LN_WIDE_BLOCKS : LN_BLOCKS) / LN_CLUSTER;
  }
  p->rpw = cdiv(rows, (long long)p->cluster * p->clusters * LN_WARPS);
  // the ring, then (wide form) w in lane order; after the rows, each warp's
  // dw and db (32 lanes x epl each) over the same bytes
  const int ring = LN_WARPS * p->stages * 2 * ln_row_bytes(h, es) + (wide ? 32 * p->epl * 4 : 0);
  const int red = LN_WARPS * 64 * p->epl * 4;
  p->smem = ring > red ? ring : red;
  return true;
}

// RMSNorm forward. A block takes a row at a time, `cpt` chunks a thread
// (chunk c of the row, c = tid + k threads); the grid fills each SM with
// RMS_THREADS_PER_SM threads' worth of blocks, so up to that many rows a block
// each, above it a run of rows a block, the next row in flight in registers
// while one reduces.
constexpr int RMS_THREADS = 256;          // a block's threads where the row's chunks allow
constexpr int RMS_MAX_CPT = 16;           // chunks a thread at most
constexpr int RMS_MAX_WIDTH = 16384;      // 1,024 threads of 16 elements
constexpr int RMS_THREADS_PER_SM = 1024;  // the grid's blocks an SM, in threads

struct RmsPlan {
  int vec;      // elements a chunk: 16 bytes of x, or 1
  int cpt;      // chunks a thread: 1, 2, 4, 8 or 16
  int threads;  // threads a block
  int rpb;      // rows a block, one after another
  int blocks;
};
constexpr int RMS_PLAN_INTS = 5;

// `aligned`: x, y and the weight start 16-byte aligned.
bool rms_plan(int rows, int h, int es, bool aligned, RmsPlan* p) {
  if (rows < 1 || h < 1 || h > RMS_MAX_WIDTH) return false;
  p->vec = aligned && (h * es) % 16 == 0 ? 16 / es : 1;
  const int nvec = h / p->vec;
  p->cpt = 1;
  while (p->cpt < RMS_MAX_CPT && p->cpt * RMS_THREADS < nvec) p->cpt *= 2;
  p->threads = (cdiv(nvec, p->cpt) + 31) / 32 * 32;
  const int per_sm = RMS_THREADS_PER_SM / p->threads > 1 ? RMS_THREADS_PER_SM / p->threads : 1;
  p->rpb = cdiv(rows, (long long)SMS * per_sm);
  p->blocks = cdiv(rows, p->rpb);
  return true;
}

// adaLN, two forms. Many rows (above ADALN_ROW_BLOCKS an SM) in the 16-byte
// form: the warp form, a warp a row at a time, `cpt` chunks a lane (chunk
// k 32 + lane); a block of ADALN_WARPS warps an SM takes a run of rows within
// one batch element, interleaved over its warps. Otherwise (few rows, or the
// one-element form): the row form, a block a row, `cpt` chunks a thread
// (chunk tid + k threads).
constexpr int ADALN_WARPS = 8;
constexpr int ADALN_MAX_WIDTH = 2048;
constexpr int ADALN_ROW_BLOCKS = 8;                 // rows an SM that take a block each
constexpr int ADALN_THREADS = 256;                  // a row-form block's threads at most
constexpr int ADALN_LANE_CPT[5] = {1, 2, 4, 6, 8};  // compiled chunks a lane, warp form
constexpr int ADALN_WARP = 0, ADALN_ROW = 1;

struct AdalnPlan {
  int form;     // ADALN_WARP or ADALN_ROW
  int vec;      // elements a chunk: 8 (16 bytes), or 1
  int cpt;      // chunks a lane (warp form) or a thread (row form)
  int threads;  // threads a block
  int rpb;      // rows a block, within one batch element
  int nb;       // blocks a batch element
};
constexpr int ADALN_PLAN_INTS = 6;

// `aligned`: x, y, scale and shift start 16-byte aligned and both modulation
// row strides are multiples of 16 bytes.
bool ada_plan(int B, int S, int h, bool aligned, AdalnPlan* p) {
  if (B < 1 || S < 1 || h < 1 || h > ADALN_MAX_WIDTH) return false;
  p->vec = aligned && h % 8 == 0 ? 8 : 1;
  const int nvec = h / p->vec;
  if (p->vec > 1 && (long long)B * S > (long long)SMS * ADALN_ROW_BLOCKS) {
    p->form = ADALN_WARP;
    p->cpt = 0;
    for (int c : ADALN_LANE_CPT)
      if (!p->cpt && c * 32 >= nvec) p->cpt = c;
    p->rpb = cdiv(S, B < SMS ? SMS / B : 1);
    p->threads = (p->rpb < ADALN_WARPS ? p->rpb : ADALN_WARPS) * 32;
  } else {
    p->form = ADALN_ROW;
    p->cpt = 1;
    while (p->cpt * ADALN_THREADS < nvec) p->cpt *= 2;
    p->threads = (cdiv(nvec, p->cpt) + 31) / 32 * 32;
    p->rpb = 1;
  }
  p->nb = cdiv(S, p->rpb);
  return true;
}

// LayerNorm's forward (B10) and fused adaLN + gated residual (B13), two forms.
// LayerNorm's many rows (above NR_ROW_BLOCKS an SM) in the 16-byte form of a
// row of at most 4 chunks a lane (the CLIP rows): the warp form, a
// warp a row (chunk k 32 + lane of a lane, `cpt` chunks), a block of NR_WARPS
// warps on as many rows of one batch element, as many blocks as the rows
// need: small blocks, so that an SM holds many rows in flight. Otherwise the
// row form, a block a row (B13's rows at any count, the few rows of the text
// and vision towers), `cpt` chunks a thread (chunk tid + k threads). The plan
// has adaLN's fields (AdalnPlan).
constexpr int OP_LN = 0, OP_FUSED = 1;        // B10's forward, B13
constexpr int NR_WARPS = 4;                   // warp form: warps (rows) a block
constexpr int NR_ROW_BLOCKS = 8;              // rows an SM that take a block each
constexpr int NR_THREADS = 256;               // a row-form block's threads at most
constexpr int NR_LANE_CPT[4] = {1, 2, 3, 4};  // chunks a lane, warp form
constexpr int NR_WARP = 0, NR_ROW = 1;
// LayerNorm's forward takes wider rows than its backward, to 4,096 (served,
// not trained): OPT-2.7B's 2,560 (BLIP-2's language model) in the row form at
// two 16-byte chunks a thread (bf16; fp32 four), 160 threads; InternVL2's
// projector and Qwen-VL's Resampler at 4,096, the same chunks at 256 threads
// (one element a load: sixteen a thread). Widths and their chunk counts:
// 2,049-4,096 wide take cpt 2 (bf16) / 4 (fp32) / 16 (one element), every one
// of them compiled (`norm_dispatch`).
constexpr int LN_FWD_MAX_WIDTH = 4096;
// `aligned`: every row pointer and per-column vector 16-byte aligned, every
// row stride (x's, the modulation rows') a multiple of 16 bytes.
bool norm_plan(int op, int B, int S, int h, int es, bool aligned, AdalnPlan* p) {
  if (B < 1 || S < 1 || h < 1 || h > (op == OP_FUSED ? ADALN_MAX_WIDTH : LN_FWD_MAX_WIDTH))
    return false;
  p->vec = aligned && (h * es) % 16 == 0 ? 16 / es : 1;
  const int nvec = h / p->vec;
  const bool many = p->vec > 1 && (long long)B * S > (long long)SMS * NR_ROW_BLOCKS;
  int lane_cpt = 0;
  for (int c : NR_LANE_CPT)
    if (!lane_cpt && c * 32 >= nvec) lane_cpt = c;
  if (many && lane_cpt && op == OP_LN) {
    p->form = NR_WARP;
    p->cpt = lane_cpt;
    p->rpb = S < NR_WARPS ? S : NR_WARPS;
    p->threads = p->rpb * 32;
  } else {
    p->form = NR_ROW;
    p->cpt = 1;
    while (p->cpt * NR_THREADS < nvec) p->cpt *= 2;
    p->threads = (cdiv(nvec, p->cpt) + 31) / 32 * 32;
    p->rpb = 1;
  }
  p->nb = cdiv(S, p->rpb);
  return true;
}

// ------------------------------------------------------------- elements
template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }
template <>
__device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Weight-like vectors of any float dtype: 0 fp32, 1 bf16, 2 fp16.
__device__ __forceinline__ float load_param(const void* p, int dtype, long long i) {
  if (dtype == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (dtype == 2) return __half2float(static_cast<const __half*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// N elements of p as floats, in pieces of 16 bytes (of N sizeof(M) where
// that is less); p aligned to a piece.
template <typename M, int N>
__device__ __forceinline__ void load_floats(const M* p, float (&out)[N]) {
  constexpr int PIECE = N * int(sizeof(M)) < 16 ? N : 16 / int(sizeof(M));
#pragma unroll
  for (int j = 0; j < N; j += PIECE) {
    const Pack<M, PIECE> v = *reinterpret_cast<const Pack<M, PIECE>*>(p + j);
#pragma unroll
    for (int e = 0; e < PIECE; ++e) out[j + e] = to_f<M>(v.v[e]);
  }
}

// Elements [i, i + N) of a weight-like vector of `dtype` (i a multiple of N,
// p 16-byte aligned where N > 1).
template <int N>
__device__ __forceinline__ void load_params(const void* p, int dtype, long long i, float (&out)[N]) {
  if (dtype == 1)
    load_floats<__nv_bfloat16, N>(static_cast<const __nv_bfloat16*>(p) + i, out);
  else if (dtype == 2)
    load_floats<__half, N>(static_cast<const __half*>(p) + i, out);
  else
    load_floats<float, N>(static_cast<const float*>(p) + i, out);
}

__device__ __forceinline__ void store_param(void* p, int dtype, long long i, float v) {
  if (dtype == 1)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else if (dtype == 2)
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// The cluster barrier, split: every thread arrives (release) once it has read
// the other blocks' shared memory and waits (acquire) before it exits, so that
// no block's shared memory goes while another reads it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Element i of `p` summed over the cluster's blocks in rank order, every
// block's value read through DSMEM at once.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster, float* p, int i,
                                             int ranks) {
  float part[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) part[r] = r < ranks ? cluster.map_shared_rank(p, r)[i] : 0.f;
  float v = 0.f;
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r) v += part[r];
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint32_t bar) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
}

// -------------------------------------------------------------- GroupNorm
struct GnArgs {
  const void* x;
  void* y;
  const void* w;
  const void* b;
  float* mean;  // (B, groups) outputs, or null
  float* rstd;
  int wdtype;   // dtype of w and b
  int n;        // rows (pixels) a batch
  int c;
  int cpg;
  int groups;
  int slab;
  int rows;     // rows a block (resident, statistics) or an apply block
  int box;
  int tile_bytes;
  int silu;
  float eps;
};

// Shared memory of a resident or statistics block: GN_HEAD bytes of
// mbarriers (one a TMA box), the tile, then the sums' scratch: each warp's
// channel sums of x and x^2 (2 slab floats a warp), the slab's group sums,
// their cluster totals, means and rstds.
struct GnShared {
  float *red, *gpart, *gtot, *gmean, *grstd;
  __device__ GnShared(unsigned char* smem, const GnArgs& a) {
    const int gs = a.slab / a.cpg;
    red = reinterpret_cast<float*>(smem + GN_HEAD + a.tile_bytes);
    gpart = red + (blockDim.x / 32) * 2 * a.slab;
    gtot = gpart + 2 * gs;
    gmean = gtot + 2 * gs;
    grstd = gmean + gs;
  }
};

// The slab's statistics from each thread's channel sums s / q (its VEC
// channels at column j = tid % nv): over the warp's lanes of the same column
// by shuffles, then over the warps, then the channels of each group, then the
// cluster's blocks in rank order, read through DSMEM. Leaves mean and rstd of
// the slab's groups in sh.gmean / sh.grstd and arrives at the cluster barrier;
// rank 0 also writes them to a.mean / a.rstd.
template <int VEC>
__device__ void gn_reduce(const GnArgs& a, float (&s)[VEC], float (&q)[VEC], const GnShared& sh,
                          int b, int sl) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, warps = blockDim.x / 32;
  const int S = a.slab, nv = S / VEC, j = tid % nv, gs = S / a.cpg;
  for (int d = nv; d < 32; d *= 2)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float os = __shfl_down_sync(0xffffffffu, s[e], d);
      const float oq = __shfl_down_sync(0xffffffffu, q[e], d);
      if (lane + d < 32) {
        s[e] += os;
        q[e] += oq;
      }
    }
  float* wred = sh.red + warp * 2 * S;
  if (nv > 32) {  // a warp covers 32 of the columns: the others are 0
    for (int i = lane; i < 2 * S; i += 32) wred[i] = 0.f;
    __syncwarp();
  }
  if (nv >= 32 || lane < nv)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      wred[j * VEC + e] = s[e];
      wred[S + j * VEC + e] = q[e];
    }
  __syncthreads();
  for (int i = tid; i < 2 * S; i += blockDim.x) {
    float v = 0.f;
    for (int w = 0; w < warps; ++w) v += sh.red[w * 2 * S + i];
    sh.red[i] = v;  // warp 0's slot: only this thread reads or writes column i
  }
  __syncthreads();
  for (int i = tid; i < 2 * gs; i += blockDim.x) {
    const float* ch = sh.red + (i / gs) * S + (i % gs) * a.cpg;
    float v = 0.f;
    for (int k = 0; k < a.cpg; ++k) v += ch[k];
    sh.gpart[i] = v;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int ranks = int(cluster.num_blocks()), rank = int(cluster.block_rank());
  for (int i = tid; i < 2 * gs; i += blockDim.x) sh.gtot[i] = cluster_sum(cluster, sh.gpart, i, ranks);
  cluster_arrive();
  __syncthreads();
  const float count = float(a.n) * float(a.cpg);
  for (int g = tid; g < gs; g += blockDim.x) {
    const float mean = sh.gtot[g] / count;
    const float var = fmaxf(sh.gtot[gs + g] / count - mean * mean, 0.f);
    const float rstd = 1.f / sqrtf(var + a.eps);
    sh.gmean[g] = mean;
    sh.grstd[g] = rstd;
    if (a.mean != nullptr && rank == 0) {
      a.mean[(long long)b * a.groups + sl * gs + g] = mean;
      a.rstd[(long long)b * a.groups + sl * gs + g] = rstd;
    }
  }
  __syncthreads();
}

// The affine of this thread's VEC channels (slab column j), from the groups'
// mean and rstd.
template <int VEC>
__device__ __forceinline__ void gn_affine(const GnArgs& a, int c0, int j, const float* gmean,
                                          const float* grstd, float (&sc)[VEC], float (&sh)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const int ch = j * VEC + e, g = ch / a.cpg;
    sc[e] = grstd[g] * load_param(a.w, a.wdtype, c0 + ch);
    sh[e] = load_param(a.b, a.wdtype, c0 + ch) - gmean[g] * sc[e];
  }
}

// x * scale + shift in fp32, then SiLU as v / (1 + e^-v) (a fast divide: an
// IEEE one made the stores compute-bound), rounded once to T.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> gn_apply_pack(const Pack<T, VEC>& in, const float (&sc)[VEC],
                                                      const float (&sh)[VEC], int silu) {
  Pack<T, VEC> out;
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float v = to_f<T>(in.v[e]) * sc[e] + sh[e];
    if (silu) v = __fdividef(v, 1.f + __expf(-v));
    out.v[e] = from_f<T>(v);
  }
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const Pack<T, VEC>& p, float (&s)[VEC], float (&q)[VEC]) {
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float f = to_f<T>(p.v[e]);
    s[e] += f;
    q[e] += f * f;
  }
}

// One block of the resident form: rank `rank` of the cluster of (batch b,
// slab sl) holds rows [rank * rows, ...) of the slab in shared memory, a TMA
// box of `box` rows at a time, each on its own mbarrier, so that the sums of
// one box run while the next lands.
template <typename T>
__global__ void __launch_bounds__(GN_THREADS) gn_resident_kernel(const __grid_constant__ CUtensorMap map,
                                                                 GnArgs a) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, S = a.slab, nv = S / VEC, lanes = blockDim.x / nv;
  const int rl = tid / nv, j = tid % nv;
  const int rank = int(cluster.block_rank()), cid = blockIdx.x / int(cluster.num_blocks());
  const int slabs = a.c / S, b = cid / slabs, sl = cid % slabs, c0 = sl * S;
  const int r0 = rank * a.rows;
  const int nrows = min(a.rows, a.n - r0);
  const GnShared sh(smem, a);
  const uint32_t bars = smem_addr(smem);
  const Pack<T, VEC>* tile = reinterpret_cast<const Pack<T, VEC>*>(smem + GN_HEAD);
  const int boxes = nrows > 0 ? (nrows + a.box - 1) / a.box : 0;
  if (tid < boxes) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bars + 8 * tid) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid < boxes) {
    const uint32_t bar = bars + 8 * tid;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"(uint32_t(a.box * S * sizeof(T)))
                 : "memory");
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(smem + GN_HEAD + tid * a.box * S * sizeof(T))),
        "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(c0), "r"(r0 + tid * a.box), "r"(b)
        : "memory");
  }
  float s[VEC], q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = q[e] = 0.f;
  if (rl < lanes) {
    int landed = -1;
    for (int r = rl; r < nrows; r += lanes) {
      if (r / a.box != landed) {
        landed = r / a.box;
        bar_wait(bars + 8 * landed);
      }
      accumulate<T, VEC>(tile[r * nv + j], s, q);
    }
    for (++landed; landed < boxes; ++landed) bar_wait(bars + 8 * landed);  // all of the tile
  }
  __syncthreads();
  gn_reduce<VEC>(a, s, q, sh, b, sl);
  float sc[VEC], shf[VEC];
  gn_affine<VEC>(a, c0, j, sh.gmean, sh.grstd, sc, shf);
  T* y = static_cast<T*>(a.y) + ((long long)b * a.n + r0) * a.c + c0 + j * VEC;
  if (rl < lanes)
    for (int r = rl; r < nrows; r += lanes)
      *reinterpret_cast<Pack<T, VEC>*>(y + (long long)r * a.c) =
          gn_apply_pack<T, VEC>(tile[r * nv + j], sc, shf, a.silu);
  cluster_wait();
}

// One block of the statistics: rank `rank` of the cluster of (b, sl) walks
// rows [rank * rows, ...) of the slab from device memory, GN_UNROLL rows a
// thread in flight.
template <typename T, int VEC>
__global__ void __launch_bounds__(GN_STATS_THREADS) gn_stats_kernel(GnArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, S = a.slab, nv = S / VEC, lanes = blockDim.x / nv;
  const int rl = tid / nv, j = tid % nv;
  const int rank = int(cluster.block_rank()), cid = blockIdx.x / int(cluster.num_blocks());
  const int slabs = a.c / S, b = cid / slabs, sl = cid % slabs, c0 = sl * S;
  const int r0 = rank * a.rows;
  const int nrows = min(a.rows, a.n - r0);
  const GnShared sh(smem, a);
  const T* x = static_cast<const T*>(a.x) + ((long long)b * a.n + r0) * a.c + c0 + j * VEC;
  float s[VEC], q[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s[e] = q[e] = 0.f;
  if (rl < lanes)
    for (int r = rl; r < nrows; r += GN_UNROLL * lanes) {
      Pack<T, VEC> p[GN_UNROLL];
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u) {
        const int rr = r + u * lanes;
        if (rr < nrows) {
          p[u] = *reinterpret_cast<const Pack<T, VEC>*>(x + (long long)rr * a.c);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) p[u].v[e] = from_f<T>(0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < GN_UNROLL; ++u) accumulate<T, VEC>(p[u], s, q);
    }
  gn_reduce<VEC>(a, s, q, sh, b, sl);
  cluster_wait();
}

// The re-read form's second launch: blocks of (b, span of `a.slab` columns,
// run of a.rows rows) normalise x with the statistics kernel's mean and rstd;
// a span is whole rows where they fit, so that its loads and stores are
// whole lines.
template <typename T, int VEC>
__global__ void __launch_bounds__(GN_THREADS) gn_apply_kernel(GnArgs a, int chunks) {
  const int tid = threadIdx.x, S = a.slab, nv = S / VEC, lanes = blockDim.x / nv;
  const int rl = tid / nv, j = tid % nv;
  if (rl >= lanes) return;
  const int cid = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int spans = a.c / S, b = cid / spans, c0 = cid % spans * S;
  const int r0 = chunk * a.rows;
  const int nrows = min(a.rows, a.n - r0);
  float sc[VEC], sh[VEC];
  const float* mean = a.mean + (long long)b * a.groups + c0 / a.cpg;
  const float* rstd = a.rstd + (long long)b * a.groups + c0 / a.cpg;
  gn_affine<VEC>(a, c0, j, mean, rstd, sc, sh);
  const long long base = ((long long)b * a.n + r0) * a.c + c0 + j * VEC;
  const T* x = static_cast<const T*>(a.x) + base;
  T* y = static_cast<T*>(a.y) + base;
  for (int r = rl; r < nrows; r += GN_UNROLL * lanes) {
    Pack<T, VEC> p[GN_UNROLL];
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) {
      const int rr = r + u * lanes;
      if (rr < nrows) p[u] = *reinterpret_cast<const Pack<T, VEC>*>(x + (long long)rr * a.c);
    }
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u) {
      const int rr = r + u * lanes;
      if (rr < nrows)
        *reinterpret_cast<Pack<T, VEC>*>(y + (long long)rr * a.c) =
            gn_apply_pack<T, VEC>(p[u], sc, sh, a.silu);
    }
  }
}

// --------------------------------------------------- LayerNorm backward
struct LnArgs {
  const void* x;
  const void* g;
  const void* w;
  void* dx;
  void* dw;
  void* db;
  float* partial;  // (clusters, 2h) fp32, several clusters
  int* tickets;    // one a cluster rank, 0 between launches
  int wdtype;
  int rows;
  int h;
  long long xs;    // row strides, elements
  long long gs;
  int rpw;
  int stages;
  int clusters;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_wait_n(int n) {
  // the ring's depth is the plan's, 1 ... 4 rows
  if (n <= 0)
    cp_wait<0>();
  else if (n == 1)
    cp_wait<1>();
  else if (n == 2)
    cp_wait<2>();
  else
    cp_wait<3>();
}

// dw or db of pair p (see ln_bwd_kernel) into its column, in the weight's dtype.
template <int VEC, int EPL>
__device__ __forceinline__ void ln_store(const LnArgs& a, int p, float v) {
  const int lane = p % 32, st = p / 32 / EPL, e = p / 32 % EPL;
  const int col = (e / VEC * 32 + lane) * VEC + e % VEC;
  if (col < a.h) store_param(st ? a.db : a.dw, a.wdtype, col, v);
}

// Chunk v of a row (elements [v VEC, (v + 1) VEC), in its ring slot, or in
// device memory where the row takes single elements) as floats.
template <typename T, int VEC>
__device__ __forceinline__ void ln_chunk(const T* r, int v, float (&out)[VEC]) {
  const Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(r + (long long)v * VEC);
#pragma unroll
  for (int e = 0; e < VEC; ++e) out[e] = to_f<T>(p.v[e]);
}

// One row of the wide form: x and g at xr / gr, read once a pass; w in lane
// order in shared memory (wsm[t 32 + lane]); the lane's elements and the
// order of its sums are the held form's, so both forms round alike.
template <typename T, int EPL, int VEC>
__device__ __forceinline__ void ln_bwd_wide_row(const T* xr, const T* gr, const float* wsm, T* dxr,
                                                int nvec, int lane, float inv_h, float eps,
                                                float (&dwa)[EPL], float (&dba)[EPL]) {
  constexpr int NVL = EPL / VEC;
  float sx = 0.f;
#pragma unroll
  for (int k = 0; k < NVL; ++k)
    if (k * 32 + lane < nvec) {
      float xc[VEC];
      ln_chunk<T, VEC>(xr, k * 32 + lane, xc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) sx += xc[e];
    }
  const float mean = warp_sum(sx) * inv_h;
  float sd = 0.f;
#pragma unroll
  for (int k = 0; k < NVL; ++k)
    if (k * 32 + lane < nvec) {
      float xc[VEC];
      ln_chunk<T, VEC>(xr, k * 32 + lane, xc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = xc[e] - mean;
        sd += d * d;
      }
    }
  const float rstd = 1.f / sqrtf(warp_sum(sd) * inv_h + eps);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < NVL; ++k)
    if (k * 32 + lane < nvec) {
      float xc[VEC], gc[VEC];
      ln_chunk<T, VEC>(xr, k * 32 + lane, xc);
      ln_chunk<T, VEC>(gr, k * 32 + lane, gc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int t = k * VEC + e;
        const float xh = (xc[e] - mean) * rstd;
        const float dxh = gc[e] * wsm[t * 32 + lane];
        s1 += dxh;
        s2 += dxh * xh;
        dwa[t] += gc[e] * xh;
        dba[t] += gc[e];
      }
    }
  s1 = warp_sum(s1) * inv_h;
  s2 = warp_sum(s2) * inv_h;
#pragma unroll
  for (int k = 0; k < NVL; ++k) {
    const int v = k * 32 + lane;
    if (v < nvec) {
      float xc[VEC], gc[VEC];
      ln_chunk<T, VEC>(xr, v, xc);
      ln_chunk<T, VEC>(gr, v, gc);
      Pack<T, VEC> out;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = (xc[e] - mean) * rstd;
        const float dxh = gc[e] * wsm[(k * VEC + e) * 32 + lane];
        out.v[e] = from_f<T>(rstd * (dxh - s1 - xh * s2));
      }
      *reinterpret_cast<Pack<T, VEC>*>(dxr + (long long)v * VEC) = out;
    }
  }
}

// Lane l of a warp takes elements (32 k + l) * VEC + e of a row, k < EPL / VEC:
// held in registers (EPL <= LN_HOLD_EPL), or read from the row a pass (wide).
template <typename T, int EPL, bool VECTOR>
__global__ void __launch_bounds__(LN_WARPS * 32, EPL <= 24 ? 2 : 1) ln_bwd_kernel(LnArgs a) {
  constexpr int VEC = VECTOR ? 16 / sizeof(T) : 1;
  constexpr int NVL = EPL / VEC;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, h = a.h;
  const int rank = int(cluster.block_rank()), ranks = int(cluster.num_blocks());
  const int cid = blockIdx.x / ranks;
  const int row_bytes = (h * int(sizeof(T)) + 15) / 16 * 16;
  const int nvec = h / VEC;
  const long long first = ((long long)blockIdx.x * LN_WARPS + warp) * a.rpw;
  const int cnt = int(max(0LL, min((long long)a.rpw, a.rows - first)));
  const T* xg = static_cast<const T*>(a.x);
  const T* gg = static_cast<const T*>(a.g);
  T* dxg = static_cast<T*>(a.dx);
  unsigned char* ring = smem + warp * a.stages * 2 * row_bytes;

  auto issue = [&](int i) {  // row first + i into its slot of the ring
    if (i < cnt) {
      unsigned char* slot = ring + (i % a.stages) * 2 * row_bytes;
      const long long row = first + i;
#pragma unroll
      for (int k = 0; k < NVL; ++k) {
        const int v = k * 32 + lane;
        if (v < nvec) {
          cp_async16(slot + v * 16, xg + row * a.xs + v * VEC);
          cp_async16(slot + row_bytes + v * 16, gg + row * a.gs + v * VEC);
        }
      }
    }
    cp_commit();
  };

  float dwa[EPL], dba[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) dwa[e] = dba[e] = 0.f;
  if constexpr (VECTOR)
    for (int i = 0; i < a.stages - 1; ++i) issue(i);
  const float inv_h = 1.f / float(h);
  if constexpr (EPL > LN_HOLD_EPL) {
    // w in lane order after the ring, while the first rows are in flight
    float* wsm = reinterpret_cast<float*>(smem + LN_WARPS * a.stages * 2 * row_bytes);
    for (int q = tid; q < EPL * 32; q += blockDim.x) {
      const int e = q / 32, col = (e / VEC * 32 + q % 32) * VEC + e % VEC;
      wsm[q] = col < h ? load_param(a.w, a.wdtype, col) : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const long long row = first + i;
      const T* xr = xg + row * a.xs;
      const T* gr = gg + row * a.gs;
      if constexpr (VECTOR) {
        issue(i + a.stages - 1);
        cp_wait_n(a.stages - 1);
        const unsigned char* slot = ring + (i % a.stages) * 2 * row_bytes;
        xr = reinterpret_cast<const T*>(slot);
        gr = reinterpret_cast<const T*>(slot + row_bytes);
      }
      ln_bwd_wide_row<T, EPL, VEC>(xr, gr, wsm, dxg + row * h, nvec, lane, inv_h, a.eps, dwa,
                                   dba);
    }
  } else {
    float wv[EPL];  // this lane's columns of w, fp32, while the first rows are in flight
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int col = (e / VEC * 32 + lane) * VEC + e % VEC;
      wv[e] = col < h ? load_param(a.w, a.wdtype, col) : 0.f;
    }
    for (int i = 0; i < cnt; ++i) {
      const long long row = first + i;
      float xv[EPL], gv[EPL];
      if constexpr (VECTOR) {
        issue(i + a.stages - 1);
        cp_wait_n(a.stages - 1);
        const unsigned char* slot = ring + (i % a.stages) * 2 * row_bytes;
#pragma unroll
        for (int k = 0; k < NVL; ++k) {
          const int v = k * 32 + lane;
          if (v < nvec) {
            const Pack<T, VEC> px = *reinterpret_cast<const Pack<T, VEC>*>(slot + v * 16);
            const Pack<T, VEC> pg = *reinterpret_cast<const Pack<T, VEC>*>(slot + row_bytes + v * 16);
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              xv[k * VEC + e] = to_f<T>(px.v[e]);
              gv[k * VEC + e] = to_f<T>(pg.v[e]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) xv[k * VEC + e] = gv[k * VEC + e] = 0.f;
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < EPL; ++k) {
          const int col = k * 32 + lane;
          xv[k] = col < h ? to_f<T>(xg[row * a.xs + col]) : 0.f;
          gv[k] = col < h ? to_f<T>(gg[row * a.gs + col]) : 0.f;
        }
      }
      float sx = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) sx += xv[e];
      const float mean = warp_sum(sx) * inv_h;
      float sd = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int col = (e / VEC * 32 + lane) * VEC + e % VEC;
        xv[e] = col < h ? xv[e] - mean : 0.f;
        sd += xv[e] * xv[e];
      }
      const float rstd = 1.f / sqrtf(warp_sum(sd) * inv_h + a.eps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        xv[e] *= rstd;  // xhat
        const float dxh = gv[e] * wv[e];
        s1 += dxh;
        s2 += dxh * xv[e];
        dwa[e] += gv[e] * xv[e];
        dba[e] += gv[e];
        gv[e] = dxh;
      }
      s1 = warp_sum(s1) * inv_h;
      s2 = warp_sum(s2) * inv_h;
#pragma unroll
      for (int k = 0; k < NVL; ++k) {
        const int v = k * 32 + lane;
        if (v < nvec) {
          Pack<T, VEC> out;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int t = k * VEC + e;
            out.v[e] = from_f<T>(rstd * (gv[t] - s1 - xv[t] * s2));
          }
          *reinterpret_cast<Pack<T, VEC>*>(dxg + row * h + v * VEC) = out;
        }
      }
    }
  }
  if constexpr (VECTOR) cp_wait<0>();
  __syncthreads();

  // The block's dw and db, warp by warp in order, in "pair" order p = (st *
  // EPL + e) * 32 + lane (st 0 dw, 1 db; the column `ln_store` gives), so that
  // the warps' writes and the sums' reads fall in distinct banks.
  constexpr int P = 2 * EPL * 32;
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    red[(warp * 2 * EPL + e) * 32 + lane] = dwa[e];
    red[(warp * 2 * EPL + EPL + e) * 32 + lane] = dba[e];
  }
  __syncthreads();
  for (int p = tid; p < P; p += blockDim.x) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < LN_WARPS; ++w) v += red[w * P + p];
    red[p] = v;  // warp 0's slot: only this thread reads or writes pair p
  }
  cluster.sync();
  // this rank's slice of the pairs, over the cluster's blocks in rank order:
  // the result, or with several clusters the cluster's partial row
  const int per = (P + ranks - 1) / ranks, p_lo = rank * per, p_hi = min(P, p_lo + per);
  float* part = a.partial + (long long)cid * P;
  for (int p = p_lo + tid; p < p_hi; p += blockDim.x) {
    const float v = cluster_sum(cluster, red, p, ranks);
    if (a.clusters == 1)
      ln_store<VEC, EPL>(a, p, v);
    else
      part[p] = v;
  }
  cluster_arrive();
  if (a.clusters > 1) {
    __shared__ int last;
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(a.tickets + rank, 1) == a.clusters - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      for (int p = p_lo + tid; p < p_hi; p += blockDim.x) {
        float v = 0.f;
        for (int q0 = 0; q0 < a.clusters; q0 += LN_GATHER) {  // in order, LN_GATHER in flight
          float pv[LN_GATHER];
#pragma unroll
          for (int u = 0; u < LN_GATHER; ++u)
            pv[u] = q0 + u < a.clusters ? __ldcg(a.partial + (long long)(q0 + u) * P + p) : 0.f;
#pragma unroll
          for (int u = 0; u < LN_GATHER; ++u) v += pv[u];
        }
        ln_store<VEC, EPL>(a, p, v);
      }
      if (tid == 0) atomicExch(a.tickets + rank, 0);
    }
  }
  cluster_wait();
}

// ------------------------------------------------------------- row norms
// The block's warps' partial sums part[w], w < warps (at most MAXW): up to 8
// loaded together and added in warp order; more, a lane a warp, added by a
// shuffle tree. Either order is fixed.
template <int MAXW>
__device__ __forceinline__ float warps_sum(const float* part, int warps) {
  if constexpr (MAXW > 8) {
    return warp_sum(int(threadIdx.x % 32) < warps ? part[threadIdx.x % 32] : 0.f);
  } else {
    float v[MAXW];
#pragma unroll
    for (int w = 0; w < MAXW; ++w) v[w] = w < warps ? part[w] : 0.f;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < MAXW; ++w)
      if (w < warps) t += v[w];
    return t;
  }
}

struct RmsArgs {
  const void* x;  // (rows, h), contiguous
  const void* w;  // (h,) of wdtype
  void* y;
  int wdtype;
  int rows;
  int h;
  int rpb;
  float eps;
};

// RMSNorm forward: rows [blockIdx.x rpb, ...) one after another, each across
// the whole block; thread tid holds chunks tid + k blockDim.x of a row, and
// this thread's columns of the weight in registers for all of the block's
// rows. The first row's loads and the weight's are issued before any is used;
// each next row's are issued before the current one reduces.
template <typename T, int VEC, int CPT>
__global__ void __launch_bounds__(VEC > 1 ? RMS_THREADS : 1024,
                                  VEC > 1 && CPT <= 2 ? RMS_THREADS_PER_SM / RMS_THREADS : 1)
    rms_norm_fwd_kernel(RmsArgs a) {
  using P = Pack<T, VEC>;
  __shared__ float part[2][32];  // each warp's sum of squares, by the row's parity
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, warps = blockDim.x / 32;
  const int nvec = a.h / VEC;
  const long long first = (long long)blockIdx.x * a.rpb;
  const int cnt = int(min((long long)a.rpb, a.rows - first));
  const P* x = static_cast<const P*>(a.x) + first * nvec;
  P* y = static_cast<P*>(a.y) + first * nvec;
  P cur[CPT], nxt[CPT];
  auto load = [&](P (&b)[CPT], int i) {
    if (i < cnt)
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int c = tid + k * int(blockDim.x);
        if (c < nvec) b[k] = x[(long long)i * nvec + c];
      }
  };
  load(cur, 0);
  float wv[CPT][VEC];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = tid + k * int(blockDim.x);
    if (c < nvec) load_params<VEC>(a.w, a.wdtype, (long long)c * VEC, wv[k]);
  }
  const float inv_h = 1.f / float(a.h);
  for (int i = 0; i < cnt; ++i) {
    load(nxt, i + 1);  // the next row in flight while this one reduces
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k)
      if (tid + k * int(blockDim.x) < nvec)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float f = to_f<T>(cur[k].v[e]);
          ss += f * f;
        }
    ss = warp_sum(ss);
    if (lane == 0) part[i & 1][warp] = ss;
    __syncthreads();
    const float r = rsqrtf(warps_sum<(VEC > 1 ? 8 : 32)>(part[i & 1], warps) * inv_h + a.eps);
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = tid + k * int(blockDim.x);
      if (c < nvec) {
        P out;
#pragma unroll
        for (int e = 0; e < VEC; ++e) out.v[e] = from_f<T>(to_f<T>(cur[k].v[e]) * r * wv[k][e]);
        y[(long long)i * nvec + c] = out;
      }
    }
#pragma unroll
    for (int k = 0; k < CPT; ++k) cur[k] = nxt[k];
  }
}

struct AdalnArgs {
  const void* x;      // (B, S, h) bf16, contiguous
  const void* scale;  // (B, h) rows, ss / hs elements apart
  const void* shift;
  void* y;
  int mdtype;         // dtype of scale and shift (0 fp32, 1 bf16, 2 fp16)
  int S;
  int h;
  long long ss;
  long long hs;
  int nb;             // blocks a batch element
  int rpb;
  float eps;
};

// adaLN, the warp form: block (b, j) takes rows [j rpb, ...) of batch element
// b, row r0 + warp + n warps on warp `warp`; lane l holds chunks k 32 + l of a
// row, and 1 + scale[b] and shift[b] at its columns in registers for all of
// the block's rows. The warp's first row's loads and the modulation rows' are
// issued before any is used; each next row's before the current one
// reduces. The mean and the variance (two-pass) are warp shuffles; no
// barrier.
template <int CPT>
__global__ void __launch_bounds__(ADALN_WARPS * 32, 1) adaln_warp_kernel(AdalnArgs a) {
  using T = __nv_bfloat16;
  using P = Pack<T, 8>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const int b = blockIdx.x / a.nb, r0 = blockIdx.x % a.nb * a.rpb;
  const int cnt = min(a.rpb, a.S - r0);
  const int nvec = a.h / 8;
  const P* x = static_cast<const P*>(a.x) + ((long long)b * a.S + r0) * nvec;
  P* y = static_cast<P*>(a.y) + ((long long)b * a.S + r0) * nvec;
  P cur[CPT], nxt[CPT];
  auto load = [&](P (&bf)[CPT], int i) {
    if (i < cnt)
#pragma unroll
      for (int k = 0; k < CPT; ++k)
        if (k * 32 + lane < nvec) bf[k] = x[(long long)i * nvec + k * 32 + lane];
  };
  load(cur, warp);
  float g[CPT][8], sh[CPT][8];
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    if (k * 32 + lane < nvec) {
      const long long c = (k * 32 + lane) * 8;
      load_params<8>(a.scale, a.mdtype, b * a.ss + c, g[k]);
      load_params<8>(a.shift, a.mdtype, b * a.hs + c, sh[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) g[k][e] = 1.f + g[k][e];
    }
  const float inv_h = 1.f / float(a.h);
  for (int i = warp; i < cnt; i += warps) {
    load(nxt, i + warps);  // the warp's next row in flight while this one reduces
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k)
      if (k * 32 + lane < nvec)
#pragma unroll
        for (int e = 0; e < 8; ++e) s += to_f<T>(cur[k].v[e]);
    const float mean = warp_sum(s) * inv_h;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < CPT; ++k)
      if (k * 32 + lane < nvec)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = to_f<T>(cur[k].v[e]) - mean;
          q += d * d;
        }
    const float rstd = rsqrtf(warp_sum(q) * inv_h + a.eps);
#pragma unroll
    for (int k = 0; k < CPT; ++k)
      if (k * 32 + lane < nvec) {
        P out;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          out.v[e] = from_f<T>((to_f<T>(cur[k].v[e]) - mean) * rstd * g[k][e] + sh[k][e]);
        y[(long long)i * nvec + k * 32 + lane] = out;
      }
#pragma unroll
    for (int k = 0; k < CPT; ++k) cur[k] = nxt[k];
  }
}

// adaLN, the row form: block (b, j) takes row j of batch element b; thread
// tid holds chunks tid + k blockDim.x, and issues all of its loads (x, scale,
// shift) before it uses any. Each warp takes its sum, then its mean and its
// sum of squared deviations from that mean, by shuffles; one shared-memory
// exchange, then every thread combines the warps' in order: the row's mean is
// the sum over h, its squared deviations sum_w [m2_w + n_w (mean_w - mean)^2]
// (the two-pass variance, combined).
template <int VEC, int CPT>
__global__ void __launch_bounds__(ADALN_THREADS) adaln_row_kernel(AdalnArgs a) {
  using T = __nv_bfloat16;
  using P = Pack<T, VEC>;
  constexpr int W = ADALN_THREADS / 32;
  __shared__ float part[4][W];  // each warp's sum, count, mean and squared deviations
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, warps = blockDim.x / 32;
  const int b = blockIdx.x / a.nb;
  const int nvec = a.h / VEC;
  const P* x = static_cast<const P*>(a.x) + (long long)blockIdx.x * nvec;
  P* y = static_cast<P*>(a.y) + (long long)blockIdx.x * nvec;
  P in[CPT];
  float g[CPT][VEC], sh[CPT][VEC];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = tid + k * int(blockDim.x);
    if (c < nvec) in[k] = x[c];
  }
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = tid + k * int(blockDim.x);
    if (c < nvec) {
      load_params<VEC>(a.scale, a.mdtype, b * a.ss + (long long)c * VEC, g[k]);
      load_params<VEC>(a.shift, a.mdtype, b * a.hs + (long long)c * VEC, sh[k]);
    }
  }
  int chunks = 0;  // this warp's chunks of the row
#pragma unroll
  for (int k = 0; k < CPT; ++k) chunks += min(32, max(0, nvec - warp * 32 - k * int(blockDim.x)));
  const float nw = float(chunks * VEC);
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    if (tid + k * int(blockDim.x) < nvec)
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += to_f<T>(in[k].v[e]);
  const float sw = warp_sum(s);
  const float mw = nw > 0.f ? __fdividef(sw, nw) : 0.f;  // the warp's pivot, its mean to fp32 rounding
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    if (tid + k * int(blockDim.x) < nvec)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = to_f<T>(in[k].v[e]) - mw;
        q += d * d;
      }
  q = warp_sum(q);
  if (lane == 0) {
    part[0][warp] = sw;
    part[1][warp] = nw;
    part[2][warp] = mw;
    part[3][warp] = q;
  }
  __syncthreads();
  const float inv_h = 1.f / float(a.h);
  const float mean = warps_sum<W>(part[0], warps) * inv_h;
  float m2 = 0.f;
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (w < warps) {
      const float d = part[2][w] - mean;
      m2 += part[3][w] + part[1][w] * d * d;
    }
  const float rstd = rsqrtf(m2 * inv_h + a.eps);
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = tid + k * int(blockDim.x);
    if (c < nvec) {
      P out;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        out.v[e] = from_f<T>((to_f<T>(in[k].v[e]) - mean) * rstd * (1.f + g[k][e]) + sh[k][e]);
      y[c] = out;
    }
  }
}

// LayerNorm's forward (OP_LN) and fused adaLN + gated residual (OP_FUSED).
struct NormArgs {
  const void* x;      // rows xs elements apart, unit column stride
  const void* res;    // B13's residual, contiguous
  void* y;            // contiguous
  void* resi;         // B13's residual sum, contiguous
  const void* v[3];   // per-column vectors: LayerNorm's w and b; B13's gate, scale and shift
  long long vs[3];    // their row strides from one batch element to the next (elements)
  int vdtype;         // dtype of the vectors (0 fp32, 1 bf16, 2 fp16)
  int S;              // rows a batch element
  int h;
  long long xs;
  int nb;             // blocks a batch element
  int rpb;            // rows a block
  float eps;
};

// Vector j's VEC values at columns [col, col + VEC) of batch element b, in
// fp32: B13's scale (j 1) as 1 + scale.
template <int OP, int VEC>
__device__ __forceinline__ void load_vector(const NormArgs& a, int j, int b, long long col,
                                            float (&v)[VEC]) {
  load_params<VEC>(a.v[j], a.vdtype, b * a.vs[j] + col, v);
  if (OP == OP_FUSED && j == 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = 1.f + v[e];
  }
}

// The fp32 value a row is normalised over: x (LayerNorm), or residual + gate
// x (B13's sum, never rounded before the moments).
template <int OP>
__device__ __forceinline__ float norm_input(float res, float x, float gate) {
  if constexpr (OP == OP_FUSED) return res + gate * x;
  return x;
}

// B13's resi at chunk c of a row: the sum rounded once, stored as soon as it
// is formed (before the moments), as the JAX kernel stores it.
template <int OP, typename T, int VEC>
__device__ __forceinline__ void store_sum(const NormArgs& a, long long row, int nvec, int c,
                                          const float (&v)[VEC]) {
  if constexpr (OP == OP_FUSED) {
    Pack<T, VEC> out;
#pragma unroll
    for (int e = 0; e < VEC; ++e) out.v[e] = from_f<T>(v[e]);
    static_cast<Pack<T, VEC>*>(a.resi)[row * nvec + c] = out;
  }
}

// The affine's vectors at chunk c of batch element b's row: the multiplier
// (LayerNorm's w, B13's 1 + scale) and the offset (b, shift).
template <int OP, int VEC>
__device__ __forceinline__ void load_affine(const NormArgs& a, int b, int c, float (&aff)[2][VEC]) {
  constexpr int MUL = OP == OP_FUSED ? 1 : 0;
  load_vector<OP, VEC>(a, MUL, b, (long long)c * VEC, aff[0]);
  load_vector<OP, VEC>(a, MUL + 1, b, (long long)c * VEC, aff[1]);
}

// y at chunk c of a row: (v - mean) rstd times the multiplier plus the
// offset, rounded once.
template <typename T, int VEC>
__device__ __forceinline__ void store_output(const NormArgs& a, long long row, int nvec, int c,
                                             const float (&v)[VEC], float mean, float rstd,
                                             const float (&aff)[2][VEC]) {
  Pack<T, VEC> out;
#pragma unroll
  for (int e = 0; e < VEC; ++e) out.v[e] = from_f<T>((v[e] - mean) * rstd * aff[0][e] + aff[1][e]);
  static_cast<Pack<T, VEC>*>(a.y)[row * nvec + c] = out;
}

// The row form: block (b, j) takes row j of batch element b; thread tid holds
// chunks tid + k blockDim.x and issues all of its loads (the row's, the
// affine's vectors and B13's gate) before it uses any. The moments two-pass
// over the block, as the plain version takes them: each warp's sum by
// shuffles, an exchange, the mean from the warps' sums in warp order; then
// each warp's squared deviations from that mean, a second exchange. (One
// exchange of each warp's sum, mean and squared deviations from it, combined
// as adaln_row_kernel does, read 24 words a thread: slower.)
template <int OP, typename T, int VEC, int CPT>
__device__ __forceinline__ void norm_row(const NormArgs& a) {
  using P = Pack<T, VEC>;
  constexpr int W = NR_THREADS / 32;
  __shared__ float sums[2][W];  // each warp's sum, then its squared deviations from the mean
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, warps = blockDim.x / 32;
  const int b = blockIdx.x / a.nb;
  const long long row = blockIdx.x;
  const int nvec = a.h / VEC;
  const P* x = reinterpret_cast<const P*>(static_cast<const T*>(a.x) + row * a.xs);
  P xin[CPT], rin[CPT];
  float g[CPT][VEC];        // B13's gate
  float aff[CPT][2][VEC];  // the affine's vectors
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = tid + k * int(blockDim.x);
    if (c < nvec) {
      xin[k] = x[c];
      if constexpr (OP == OP_FUSED) {
        rin[k] = static_cast<const P*>(a.res)[row * nvec + c];
        load_vector<OP, VEC>(a, 0, b, (long long)c * VEC, g[k]);
      }
      load_affine<OP, VEC>(a, b, c, aff[k]);
    }
  }
  float v[CPT][VEC];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    if (tid + k * int(blockDim.x) < nvec) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[k][e] = norm_input<OP>(OP == OP_FUSED ? to_f<T>(rin[k].v[e]) : 0.f, to_f<T>(xin[k].v[e]),
                                 OP == OP_FUSED ? g[k][e] : 0.f);
        s += v[k][e];
      }
      store_sum<OP, T, VEC>(a, row, nvec, tid + k * int(blockDim.x), v[k]);
    }
  const float sw = warp_sum(s);
  if (lane == 0) sums[0][warp] = sw;
  __syncthreads();
  const float inv_h = 1.f / float(a.h);
  const float mean = warps_sum<W>(sums[0], warps) * inv_h;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    if (tid + k * int(blockDim.x) < nvec)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = v[k][e] - mean;
        q += d * d;
      }
  q = warp_sum(q);
  if (lane == 0) sums[1][warp] = q;
  __syncthreads();
  const float rstd = rsqrtf(warps_sum<W>(sums[1], warps) * inv_h + a.eps);
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = tid + k * int(blockDim.x);
    if (c < nvec) store_output<T, VEC>(a, row, nvec, c, v[k], mean, rstd, aff[k]);
  }
}

// LayerNorm's warp form: block (b, j) takes rows j rpb + warp of batch
// element b, a row a warp; lane l holds chunks k 32 + l of the row and issues
// all of its loads of the row before it uses any. The mean and the
// variance (two-pass) are warp shuffles; no barrier. The affine's vectors are
// read after the moments, so that no register holds them while the row is in
// flight: small blocks of few registers, so that an SM holds many rows.
template <typename T, int CPT>
__device__ __forceinline__ void norm_warp(const NormArgs& a) {
  constexpr int VEC = 16 / sizeof(T);
  using P = Pack<T, VEC>;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x / a.nb, r = blockIdx.x % a.nb * a.rpb + warp;
  if (r >= a.S) return;
  const long long row = (long long)b * a.S + r;
  const int nvec = a.h / VEC;
  const P* x = reinterpret_cast<const P*>(static_cast<const T*>(a.x) + row * a.xs);
  P xin[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    if (k * 32 + lane < nvec) xin[k] = x[k * 32 + lane];
  float v[CPT][VEC];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    if (k * 32 + lane < nvec)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[k][e] = to_f<T>(xin[k].v[e]);
        s += v[k][e];
      }
  const float inv_h = 1.f / float(a.h);
  const float mean = warp_sum(s) * inv_h;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    if (k * 32 + lane < nvec)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = v[k][e] - mean;
        q += d * d;
      }
  const float rstd = rsqrtf(warp_sum(q) * inv_h + a.eps);
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    if (k * 32 + lane < nvec) {
      float aff[2][VEC];
      load_affine<OP_LN, VEC>(a, b, k * 32 + lane, aff);
      store_output<T, VEC>(a, row, nvec, k * 32 + lane, v[k], mean, rstd, aff);
    }
}

// The kernels, by name (a profile tells B10's from B13's by it).
template <typename T, int CPT>
__global__ void __launch_bounds__(NR_WARPS * 32) layer_norm_fwd_warp_kernel(NormArgs a) {
  norm_warp<T, CPT>(a);
}
template <typename T, int VEC, int CPT>
__global__ void __launch_bounds__(NR_THREADS) layer_norm_fwd_row_kernel(NormArgs a) {
  norm_row<OP_LN, T, VEC, CPT>(a);
}
template <int VEC, int CPT>
__global__ void __launch_bounds__(NR_THREADS) fused_adaln_residual_row_kernel(NormArgs a) {
  norm_row<OP_FUSED, __nv_bfloat16, VEC, CPT>(a);
}

// An empty kernel: the floor of a launch shape, timed as the kernels are.
__global__ void empty_kernel() {}

// ------------------------------------------------------------- launches
template <auto KERNEL>
cudaError_t configure() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return e;
  }();
  return err;
}

template <auto KERNEL, typename... Args>
int launch(int grid, int threads, int smem, int cluster, cudaStream_t stream, Args... args) {
  const cudaError_t err = configure<KERNEL>();
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, KERNEL, args...);
  return int(e != cudaSuccess ? e : cudaGetLastError());
}

template <auto KERNEL>
int max_clusters(int threads, int smem, int cluster) {
  if (configure<KERNEL>() != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 1024);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, KERNEL, &cfg) == cudaSuccess ? n : -1;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda that the CUDA runtime has loaded.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// x (B, n, c) read as (c, n, B); a box is the slab's `slab` channels x `box`
// rows of one batch, and rows past n read as zeros.
CUresult gn_map(CUtensorMap* map, const void* x, int dtype, int B, int n, int c, int slab, int box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  const int es = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[3] = {cuuint64_t(c), cuuint64_t(n), cuuint64_t(B)};
  const cuuint64_t strides[2] = {cuuint64_t(c) * es, cuuint64_t(n) * c * es};
  const cuuint32_t boxdim[3] = {cuuint32_t(slab), cuuint32_t(box), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type = dtype == 0   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  return encode(map, type, 3, const_cast<void*>(x), dims, strides, boxdim, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

bool same_plan(const int* a, const int* b, int n) {
  for (int i = 0; i < n; ++i)
    if (a[i] != b[i]) return false;
  return true;
}

int es_of(int dtype) { return dtype == 0 ? 4 : 2; }

// dtype: 0 fp32, 1 bf16, 2 fp16
template <typename T>
int gn_run(const GnPlan& p, GnArgs a, int B, cudaStream_t st) {
  const int clusters = B * (a.c / p.slab);
  const int dtype = sizeof(T) == 4 ? 0 : std::is_same<T, __nv_bfloat16>::value ? 1 : 2;
  a.slab = p.slab;
  if (p.form == 0) {
    CUtensorMap map;
    const CUresult r = gn_map(&map, a.x, dtype, B, a.n, a.c, p.slab, p.box);
    if (r != CUDA_SUCCESS) return TENSOR_MAP_ERROR + int(r);
    a.rows = p.rows;
    a.box = p.box;
    a.tile_bytes = cdiv(p.rows, p.box) * p.box * p.slab * int(sizeof(T));
    return launch<gn_resident_kernel<T>>(clusters * p.cluster, p.threads, p.smem, p.cluster, st,
                                         map, a);
  }
  a.rows = p.rows;
  a.tile_bytes = 0;
  int err = p.vec > 1
                ? launch<gn_stats_kernel<T, 16 / sizeof(T)>>(clusters * p.cluster, p.threads,
                                                              p.smem, p.cluster, st, a)
                : launch<gn_stats_kernel<T, 1>>(clusters * p.cluster, p.threads, p.smem,
                                                p.cluster, st, a);
  if (err != 0 || a.y == nullptr) return err;
  const int chunks = cdiv(a.n, p.apply_rows);
  const int grid = B * (a.c / p.apply_span) * chunks;
  a.rows = p.apply_rows;
  a.slab = p.apply_span;
  return p.vec > 1 ? launch<gn_apply_kernel<T, 16 / sizeof(T)>>(grid, GN_THREADS, 0, 1, st, a,
                                                                 chunks)
                   : launch<gn_apply_kernel<T, 1>>(grid, GN_THREADS, 0, 1, st, a, chunks);
}

template <typename T, int EPL, bool VECTOR>
int ln_run(const LnPlan& p, const LnArgs& a, cudaStream_t st) {
  return launch<ln_bwd_kernel<T, EPL, VECTOR>>(p.cluster * p.clusters, p.warps * 32, p.smem,
                                               p.cluster, st, a);
}

template <typename T>
int ln_dispatch(const LnPlan& p, const LnArgs& a, cudaStream_t st) {
  if (p.vec == 1)
    return p.epl == LN_WIDE_EPL ? ln_run<T, LN_WIDE_EPL, false>(p, a, st)
                                : ln_run<T, LN_HOLD_EPL, false>(p, a, st);
  switch (p.epl) {
    case 8: return ln_run<T, 8, true>(p, a, st);
    case 16: return ln_run<T, 16, true>(p, a, st);
    case 24: return ln_run<T, 24, true>(p, a, st);
    case 32: return ln_run<T, 32, true>(p, a, st);
    case 40: return ln_run<T, 40, true>(p, a, st);
    case 64: return ln_run<T, 64, true>(p, a, st);
  }
  return int(cudaErrorInvalidValue);
}

template <auto KERNEL, typename Args>
int row_launch(int grid, int threads, cudaStream_t st, const Args& a) {
  KERNEL<<<grid, threads, 0, st>>>(a);
  return int(cudaGetLastError());
}

template <auto KERNEL>
int rms_start(const RmsPlan& p, const RmsArgs& a, cudaStream_t st) {
  return row_launch<KERNEL>(p.blocks, p.threads, st, a);
}

template <typename T, int VEC>
int rms_launch(const RmsPlan& p, const RmsArgs& a, cudaStream_t st) {
  switch (p.cpt) {
    case 1: return rms_start<rms_norm_fwd_kernel<T, VEC, 1>>(p, a, st);
    case 2: return rms_start<rms_norm_fwd_kernel<T, VEC, 2>>(p, a, st);
    case 4: return rms_start<rms_norm_fwd_kernel<T, VEC, 4>>(p, a, st);
    case 8: return rms_start<rms_norm_fwd_kernel<T, VEC, 8>>(p, a, st);
  }
  // 16 chunks a thread: fp32 rows above 4,096 (16-byte form) or one-element rows above 4,096
  if constexpr (VEC != 8)
    if (p.cpt == 16) return rms_start<rms_norm_fwd_kernel<T, VEC, 16>>(p, a, st);
  return int(cudaErrorInvalidValue);
}

template <typename T>
int rms_dispatch(const RmsPlan& p, const RmsArgs& a, cudaStream_t st) {
  return p.vec > 1 ? rms_launch<T, 16 / sizeof(T)>(p, a, st) : rms_launch<T, 1>(p, a, st);
}

int adaln_dispatch(const AdalnPlan& p, const AdalnArgs& a, int B, cudaStream_t st) {
  const int grid = B * p.nb;
  if (p.form == ADALN_WARP) {
    switch (p.cpt) {
      case 1: return row_launch<adaln_warp_kernel<1>>(grid, p.threads, st, a);
      case 2: return row_launch<adaln_warp_kernel<2>>(grid, p.threads, st, a);
      case 4: return row_launch<adaln_warp_kernel<4>>(grid, p.threads, st, a);
      case 6: return row_launch<adaln_warp_kernel<6>>(grid, p.threads, st, a);
      case 8: return row_launch<adaln_warp_kernel<8>>(grid, p.threads, st, a);
    }
  } else if (p.vec > 1) {
    if (p.cpt == 1) return row_launch<adaln_row_kernel<8, 1>>(grid, p.threads, st, a);
  } else {
    switch (p.cpt) {
      case 1: return row_launch<adaln_row_kernel<1, 1>>(grid, p.threads, st, a);
      case 2: return row_launch<adaln_row_kernel<1, 2>>(grid, p.threads, st, a);
      case 4: return row_launch<adaln_row_kernel<1, 4>>(grid, p.threads, st, a);
      case 8: return row_launch<adaln_row_kernel<1, 8>>(grid, p.threads, st, a);
    }
  }
  return int(cudaErrorInvalidValue);
}

// f(std::integral_constant<int, C>{}) for the compiled chunk count C == cpt.
template <typename F>
int with_cpt(int cpt, F&& f) {
  switch (cpt) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
  }
  return int(cudaErrorInvalidValue);
}

// The kernel of a plan: LayerNorm's warp form's chunk counts, the row form's powers
// of two up to its widest row's (16-byte chunks: B13 1 (2,048 bf16), LayerNorm
// bf16 2 and fp32 4 (4,096); single elements: B13 8, LayerNorm 16).
template <int OP, typename T>
int norm_dispatch(const AdalnPlan& p, const NormArgs& a, int B, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int grid = B * p.nb;
  return with_cpt(p.cpt, [&](auto c) -> int {
    constexpr int C = decltype(c)::value;
    if (p.form == NR_WARP) {
      if constexpr (OP == OP_LN && C <= 4)
        return row_launch<layer_norm_fwd_warp_kernel<T, C>>(grid, p.threads, st, a);
    } else if (p.vec > 1) {
      if constexpr (OP == OP_FUSED ? C == 1 : C <= (sizeof(T) == 4 ? 4 : 2)) {
        if constexpr (OP == OP_FUSED)
          return row_launch<fused_adaln_residual_row_kernel<VEC, C>>(grid, p.threads, st, a);
        else
          return row_launch<layer_norm_fwd_row_kernel<T, VEC, C>>(grid, p.threads, st, a);
      }
    } else if constexpr ((C & (C - 1)) == 0 && C <= (OP == OP_FUSED ? 8 : 16)) {
      if constexpr (OP == OP_FUSED)
        return row_launch<fused_adaln_residual_row_kernel<1, C>>(grid, p.threads, st, a);
      else
        return row_launch<layer_norm_fwd_row_kernel<T, 1, C>>(grid, p.threads, st, a);
    }
    return int(cudaErrorInvalidValue);
  });
}

// Launches go to `device`: the calling thread's current device is set for the
// launch and restored after it.
struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int device) {
    int cur = 0;
    if (cudaGetDevice(&cur) == cudaSuccess && cur != device && cudaSetDevice(device) == cudaSuccess)
      prev = cur;
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// The GroupNorm plan of a (B, n, C) map of `dtype` (0 fp32, 1 bf16, 2 fp16)
// in `groups` groups (aligned: x starts 16-byte aligned; stats: the
// statistics alone) into plan[10] (GnPlan's fields in order). Returns 0, or
// -1 where no plan takes the shape.
extern "C" int group_norm_plan(int B, int n, int c, int groups, int dtype, int aligned, int stats,
                               int* plan) {
  GnPlan p;
  if (B < 1 || n < 1 || groups < 1 || c % groups ||
      !gn_plan(B, n, c, groups, es_of(dtype), aligned != 0, stats != 0, &p))
    return -1;
  const int v[GN_PLAN_INTS] = {p.form, p.slab, p.vec, p.cluster, p.rows, p.threads, p.box,
                               p.smem, p.apply_rows, p.apply_span};
  for (int i = 0; i < GN_PLAN_INTS; ++i) plan[i] = v[i];
  return 0;
}

// GroupNorm (+ SiLU) of x (B, n, C) contiguous, of `dtype`, into y (the same),
// with w / b (C,) of wdtype; or, with y null, the statistics alone. mean /
// rstd: (B, groups) fp32, written by the statistics (null for the resident
// form). plan: the caller's group_norm_plan, which must equal the library's.
// Returns the cudaError_t of the launch(es), PLAN_MISMATCH, or
// TENSOR_MAP_ERROR + a CUresult.
extern "C" int group_norm_cuda(const void* x, const void* w, const void* b, int wdtype, void* y,
                               float* mean, float* rstd, int dtype, int B, int n, int c,
                               int groups, float eps, int silu, const int* plan, void* stream) {
  int own[GN_PLAN_INTS];
  if (group_norm_plan(B, n, c, groups, dtype, reinterpret_cast<uintptr_t>(x) % 16 == 0,
                      y == nullptr, own) != 0 ||
      !same_plan(own, plan, GN_PLAN_INTS))
    return PLAN_MISMATCH;
  const GnPlan p{own[0], own[1], own[2], own[3], own[4], own[5], own[6], own[7], own[8], own[9]};
  if ((p.form == 1 || y == nullptr) && (mean == nullptr || rstd == nullptr))
    return int(cudaErrorInvalidValue);
  GnArgs a = {};
  a.x = x;
  a.y = y;
  a.w = w;
  a.b = b;
  a.wdtype = wdtype;
  a.mean = mean;
  a.rstd = rstd;
  a.n = n;
  a.c = c;
  a.cpg = c / groups;
  a.groups = groups;
  a.silu = silu;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gn_run<float>(p, a, B, st);
  if (dtype == 1) return gn_run<__nv_bfloat16>(p, a, B, st);
  return gn_run<__half>(p, a, B, st);
}

// The LayerNorm backward's plan of `rows` rows of width h, of `dtype`
// (aligned: x, g and dx 16-byte aligned, row strides multiples of 16 bytes)
// into plan[8] (LnPlan's fields in order). Returns 0, or -1 where no plan
// takes the shape.
extern "C" int layer_norm_bwd_plan(int rows, int h, int dtype, int aligned, int* plan) {
  LnPlan p;
  if (!ln_plan(rows, h, es_of(dtype), aligned != 0, &p)) return -1;
  const int v[LN_PLAN_INTS] = {p.vec, p.epl, p.stages, p.warps, p.cluster, p.clusters, p.rpw,
                               p.smem};
  for (int i = 0; i < LN_PLAN_INTS; ++i) plan[i] = v[i];
  return 0;
}

// (dx, dw, db) of LayerNorm: x and g (rows, h) of `dtype` (0 fp32, 1 bf16)
// with row strides xs / gs (elements, unit column stride), w (h,) of wdtype;
// dx (rows, h) contiguous of `dtype`, dw / db (h,) of wdtype. partial: fp32
// (clusters, 64 epl) scratch (unused with one cluster); tickets: 16 ints, 0, left
// 0. plan: the caller's layer_norm_bwd_plan, which must equal the library's.
extern "C" int layer_norm_bwd_cuda(const void* x, const void* g, const void* w, int wdtype,
                                   void* dx, void* dw, void* db, float* partial, int* tickets,
                                   int dtype, int rows, int h, long long xs, long long gs,
                                   float eps, const int* plan, void* stream) {
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                       (xs * es_of(dtype)) % 16 == 0 && (gs * es_of(dtype)) % 16 == 0;
  int own[LN_PLAN_INTS];
  if (layer_norm_bwd_plan(rows, h, dtype, aligned, own) != 0 ||
      !same_plan(own, plan, LN_PLAN_INTS))
    return PLAN_MISMATCH;
  const LnPlan p{own[0], own[1], own[2], own[3], own[4], own[5], own[6], own[7]};
  LnArgs a = {};
  a.x = x;
  a.g = g;
  a.w = w;
  a.dx = dx;
  a.dw = dw;
  a.db = db;
  a.partial = partial;
  a.tickets = tickets;
  a.wdtype = wdtype;
  a.rows = rows;
  a.h = h;
  a.xs = xs;
  a.gs = gs;
  a.rpw = p.rpw;
  a.stages = p.stages;
  a.clusters = p.clusters;
  a.eps = eps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ln_dispatch<float>(p, a, st);
  if (dtype == 1) return ln_dispatch<__nv_bfloat16>(p, a, st);
  return int(cudaErrorInvalidValue);
}

// The RMSNorm forward's plan of `rows` rows of width h, of `dtype` (aligned:
// x, y and the weight 16-byte aligned) into plan[5] (RmsPlan's fields in
// order). Returns 0, or -1 where no plan takes the shape.
extern "C" int rms_norm_plan(int rows, int h, int dtype, int aligned, int* plan) {
  RmsPlan p;
  if (!rms_plan(rows, h, es_of(dtype), aligned != 0, &p)) return -1;
  const int v[RMS_PLAN_INTS] = {p.vec, p.cpt, p.threads, p.rpb, p.blocks};
  for (int i = 0; i < RMS_PLAN_INTS; ++i) plan[i] = v[i];
  return 0;
}

// RMSNorm of x (rows, h) contiguous, of `dtype` (0 fp32, 1 bf16, 2 fp16), into
// y (the same), with w (h,) of wdtype, on CUDA device `device`. plan: the
// caller's rms_norm_plan, which must equal the library's. Returns the
// cudaError_t of the launch, or PLAN_MISMATCH.
extern "C" int rms_norm_cuda(const void* x, const void* w, int wdtype, void* y, int dtype,
                             int rows, int h, float eps, const int* plan, int device,
                             void* stream) {
  int own[RMS_PLAN_INTS];
  if (rms_norm_plan(rows, h, dtype, aligned16(x) && aligned16(y) && aligned16(w), own) != 0 ||
      !same_plan(own, plan, RMS_PLAN_INTS))
    return PLAN_MISMATCH;
  const RmsPlan p{own[0], own[1], own[2], own[3], own[4]};
  const RmsArgs a{x, w, y, wdtype, rows, h, p.rpb, eps};
  const DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return rms_dispatch<float>(p, a, st);
  if (dtype == 1) return rms_dispatch<__nv_bfloat16>(p, a, st);
  return rms_dispatch<__half>(p, a, st);
}

// adaLN's plan of x (B, S, h) (aligned: x, y, scale and shift 16-byte
// aligned, both modulation row strides multiples of 16 bytes) into plan[6]
// (AdalnPlan's fields in order). Returns 0, or -1 where no plan takes the
// shape.
extern "C" int adaln_plan(int B, int S, int h, int aligned, int* plan) {
  AdalnPlan p;
  if (!ada_plan(B, S, h, aligned != 0, &p)) return -1;
  const int v[ADALN_PLAN_INTS] = {p.form, p.vec, p.cpt, p.threads, p.rpb, p.nb};
  for (int i = 0; i < ADALN_PLAN_INTS; ++i) plan[i] = v[i];
  return 0;
}

// adaLN of x (B, S, h) bf16, contiguous, into y (the same), on CUDA device
// `device`: scale and shift (B, h) of mdtype with unit column stride and row
// strides ss / hs (elements). plan: the caller's adaln_plan, which must equal
// the library's. Returns the cudaError_t of the launch, or PLAN_MISMATCH.
extern "C" int adaln_cuda(const void* x, const void* scale, const void* shift, int mdtype,
                          void* y, int B, int S, int h, long long ss, long long hs, float eps,
                          const int* plan, int device, void* stream) {
  const bool aligned = aligned16(x) && aligned16(y) && aligned16(scale) && aligned16(shift) &&
                       (ss * es_of(mdtype)) % 16 == 0 && (hs * es_of(mdtype)) % 16 == 0;
  int own[ADALN_PLAN_INTS];
  if (adaln_plan(B, S, h, aligned, own) != 0 || !same_plan(own, plan, ADALN_PLAN_INTS))
    return PLAN_MISMATCH;
  const AdalnPlan p{own[0], own[1], own[2], own[3], own[4], own[5]};
  const AdalnArgs a{x, scale, shift, y, mdtype, S, h, ss, hs, p.nb, p.rpb, eps};
  const DeviceGuard guard(device);
  return adaln_dispatch(p, a, B, static_cast<cudaStream_t>(stream));
}

static int norm_plan_ints(int op, int B, int S, int h, int es, int aligned, int* plan) {
  AdalnPlan p;
  if (!norm_plan(op, B, S, h, es, aligned != 0, &p)) return -1;
  const int v[ADALN_PLAN_INTS] = {p.form, p.vec, p.cpt, p.threads, p.rpb, p.nb};
  for (int i = 0; i < ADALN_PLAN_INTS; ++i) plan[i] = v[i];
  return 0;
}

static AdalnPlan plan_of(const int* v) { return AdalnPlan{v[0], v[1], v[2], v[3], v[4], v[5]}; }

// B13's plan of x (B, S, h) bf16 (aligned: the residual, x, y, resi, gate,
// scale and shift 16-byte aligned, the modulation row strides multiples of 16
// bytes) into plan[6] (AdalnPlan's fields in order). Returns 0, or -1 where no
// plan takes the shape.
extern "C" int fused_adaln_plan(int B, int S, int h, int aligned, int* plan) {
  return norm_plan_ints(OP_FUSED, B, S, h, 2, aligned, plan);
}

// (y, resi) of B13: resi = residual + gate x in fp32, y = LN(resi) (1 + scale)
// + shift, each rounded once to bf16; residual, x, y and resi (B, S, h) bf16,
// contiguous; gate, scale and shift (B, h) of mdtype with unit column stride
// and row strides gs / ss / hs (elements); on CUDA device `device`. plan: the
// caller's fused_adaln_plan, which must equal the library's. Returns the
// cudaError_t of the launch, or PLAN_MISMATCH.
extern "C" int fused_adaln_cuda(const void* res, const void* x, const void* gate, const void* scale,
                                const void* shift, int mdtype, void* y, void* resi, int B, int S,
                                int h, long long gs, long long ss, long long hs, float eps,
                                const int* plan, int device, void* stream) {
  const int mes = es_of(mdtype);
  const bool aligned = aligned16(res) && aligned16(x) && aligned16(y) && aligned16(resi) &&
                       aligned16(gate) && aligned16(scale) && aligned16(shift) &&
                       (gs * mes) % 16 == 0 && (ss * mes) % 16 == 0 && (hs * mes) % 16 == 0;
  int own[ADALN_PLAN_INTS];
  if (fused_adaln_plan(B, S, h, aligned, own) != 0 || !same_plan(own, plan, ADALN_PLAN_INTS))
    return PLAN_MISMATCH;
  const AdalnPlan p = plan_of(own);
  const NormArgs a{x, res, y, resi, {gate, scale, shift}, {gs, ss, hs}, mdtype, S, h, h, p.nb,
                   p.rpb, eps};
  const DeviceGuard guard(device);
  return norm_dispatch<OP_FUSED, __nv_bfloat16>(p, a, B, static_cast<cudaStream_t>(stream));
}

// LayerNorm's forward plan of `rows` rows of width h, of `dtype` (aligned: x,
// y, w and b 16-byte aligned, x's row stride a multiple of 16 bytes) into
// plan[6]. Returns 0, or -1 where no plan takes the shape.
extern "C" int layer_norm_plan(int rows, int h, int dtype, int aligned, int* plan) {
  return norm_plan_ints(OP_LN, 1, rows, h, es_of(dtype), aligned, plan);
}

// LayerNorm of x (rows, h) of `dtype` (0 fp32, 1 bf16) with row stride xs
// (elements, unit column stride) into y (rows, h) contiguous: (x - mean)
// rsqrt(var + eps) w + b in fp32, rounded once; w and b (h,) of wdtype; on
// CUDA device `device`. plan: the caller's layer_norm_plan, which must equal
// the library's. Returns the cudaError_t of the launch, or PLAN_MISMATCH.
extern "C" int layer_norm_cuda(const void* x, const void* w, const void* b, int wdtype, void* y,
                               int dtype, int rows, int h, long long xs, float eps,
                               const int* plan, int device, void* stream) {
  const bool aligned = aligned16(x) && aligned16(y) && aligned16(w) && aligned16(b) &&
                       (xs * es_of(dtype)) % 16 == 0;
  if (dtype == 2) return int(cudaErrorInvalidValue);  // bf16 or fp32 rows
  int own[ADALN_PLAN_INTS];
  if (layer_norm_plan(rows, h, dtype, aligned, own) != 0 || !same_plan(own, plan, ADALN_PLAN_INTS))
    return PLAN_MISMATCH;
  const AdalnPlan p = plan_of(own);
  const NormArgs a{x, nullptr, y, nullptr, {w, b, nullptr}, {0, 0, 0}, wdtype, rows, h, xs, p.nb,
                   p.rpb, eps};
  const DeviceGuard guard(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? norm_dispatch<OP_LN, float>(p, a, 1, st)
                    : norm_dispatch<OP_LN, __nv_bfloat16>(p, a, 1, st);
}

// `count` launches of an empty kernel of `blocks` x `threads` on CUDA device
// `device`: the floor of a kernel's launch shape.
extern "C" int norms_empty_launch(int blocks, int threads, int count, int device, void* stream) {
  const DeviceGuard guard(device);
  for (int i = 0; i < count; ++i) empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}

// Clusters of a plan that the card runs at once (cudaOccupancyMaxActiveClusters):
// kind 0 the GroupNorm resident kernel, 1 its statistics, 2 the LayerNorm
// backward (at EPL 24, the CLIP rows'), 3 its wide form (EPL 64), of bf16;
// -1 where the query fails.
extern "C" int norms_max_clusters(int kind, int threads, int smem, int cluster) {
  if (kind == 0) return max_clusters<gn_resident_kernel<__nv_bfloat16>>(threads, smem, cluster);
  if (kind == 1) return max_clusters<gn_stats_kernel<__nv_bfloat16, 8>>(threads, smem, cluster);
  if (kind == 3) return max_clusters<ln_bwd_kernel<__nv_bfloat16, LN_WIDE_EPL, true>>(threads, smem, cluster);
  return max_clusters<ln_bwd_kernel<__nv_bfloat16, 24, true>>(threads, smem, cluster);
}
