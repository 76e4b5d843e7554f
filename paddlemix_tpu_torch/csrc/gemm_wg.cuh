// The shared wgmma GEMM core of the int8 a8w8 GEMM (csrc/int8_gemm.cu, B2),
// the weight-only int8 GEMM's tiled path (csrc/wint8_gemm.cu, B6) and the
// int8 3x3 convs' implicit GEMM (csrc/int8_conv3x3.cu, B3 and B5). All
// multiply by an int8 weight, K-contiguous. B2 and B6 convert one operand in
// registers on its way to the tensor cores (B2 quantizes bf16 x to s8, B6
// widens the s8 weight to bf16), so they feed `wgmma` its A operand from
// registers and its B operand from shared memory by descriptor (the RS form);
// the convs read an int8 map that was quantized beforehand, so both of their
// operands come from shared memory by descriptor (the SS form: no register
// build at all).
//
// A block is 384 threads, one a streaming multiprocessor, persistent, and two
// blocks make a cluster whose two output tiles read the same rows of one
// operand: each block loads half of that operand's stage for both (TMA
// multicast), so it crosses from L2 once a cluster. The cluster walks units
// (pairs of tiles) c, c + clusters, ...; ops/gemm_tiles.py mirrors the walk
// and picks the tile width. The producer warpgroup's first thread keeps a
// ring of K stages full by TMA (each stage 64 deep in K); a stage is refilled
// once the consumers of both blocks released it, and the ring runs on across
// tiles, so a tile's loads go out while the previous tile's epilogue runs.
// Two consumer warpgroups own 64 rows of the tile's A side each (`setmaxnreg`
// 40 / 232) and keep their accumulators in registers. In the RS form each
// builds the A fragments of every k-step of stage i + 1 while the products of
// stage i run as one group (two sets of fragments); in the SS form it issues
// stage i + 1's products as soon as the stage has landed. A stage is released
// once its group has completed. The epilogue writes the tile once: the
// column values it needs were loaded when the tile began; each warpgroup
// converts and scales its accumulators, stores them as bf16 into a swizzled
// staging tile by stmatrix, and one thread hands that to a TMA store, which
// drains while the next tile's products run. TMA zero-fills reads past the
// operands' edges (zero quantizes to zero and widens to zero) and clips the
// stores, so ragged edges need no masks.
//
// A spec (struct A8W8 in int8_gemm.cu, Wint8 in wint8_gemm.cu, Conv in
// int8_conv3x3.cu) says what a stage holds and how it is loaded, whether its
// A operand is built in registers (`SS` false: how a thread builds its A
// fragment of a k-step) or read by descriptor (`SS` true), which wgmma it
// issues, and its epilogue. Each consumer warpgroup also has a barrier of its
// own (`Staging::aux`) for TMA loads of the spec's into its staging tile (the
// convs' residual).
#pragma once

#include "wgmma.cuh"

namespace {

namespace wg {

// ---------------------------------------------- blocks beside wgmma.cuh's

// One 2-d TMA box into shared memory at `dst`; its bytes complete a
// transaction on `bar`. c0 is the contiguous coordinate.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same box into shared memory at `dst` of every block of the cluster in
// `mask`; the bytes complete a transaction on the barrier at `bar` of each.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// One 3-d TMA box into shared memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same 3-d box into every block of the cluster in `mask`.
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1, int c2,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5}], [%2], %6;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "h"(mask)
      : "memory");
}

// One 4-d TMA box into shared memory at `dst`, completing on `bar`;
// coordinates may be negative or past the edges (those elements read zero).
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The same 4-d box into every block of the cluster in `mask`.
__device__ __forceinline__ void tma_load_4d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1, int c2,
                                                      int c3, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "h"(mask)
      : "memory");
}

// Arrive on the barrier at `bar` of block `rank` of the cluster.
__device__ __forceinline__ void bar_arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 addr;\nmapa.shared::cluster.u32 addr, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [addr];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// One 2-d TMA box from shared memory at `src` to global memory, in this
// thread's bulk group; the parts past the tensor's edges are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.tile.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

// One 4-d TMA box from shared memory at `src` to global memory, clipped to
// the tensor's edges, in this thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's bulk stores have read their shared memory (it may be written again).
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// This thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to the async proxy (TMA).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of the 128 threads of one warpgroup (named barrier `id`, 1 or 2).
__device__ __forceinline__ void sync_warpgroup(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// Four 8 x 8 b16 matrices from their m16n8 fragments (register i of lane l:
// row l / 4, columns 2 (l % 4) and + 1 of matrix i); lanes 8i .. 8i + 7 give
// the addresses of matrix i's rows. `trans`: row r of the stored matrix is
// the fragment's column r.
template <bool TRANS>
__device__ __forceinline__ void stmatrix4(uint32_t addr, const uint32_t (&r)[4]) {
  if constexpr (TRANS)
    asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
                 ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
  else
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
                 ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}

// The inverse of stmatrix4<false>: four 8 x 8 b16 matrices into their m16n8
// fragments, lanes 8i .. 8i + 7 addressing matrix i's rows.
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

template <int N>
__device__ __forceinline__ void pin(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void pin(int (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) pin(r[i]);
}

// wgmma's descriptor of a K-major operand in the 64-byte swizzle: rows of 64
// bytes, 8-row groups SBO = 512 apart (layout type 2 in bits 62-63).
__device__ __forceinline__ uint64_t smem_desc_sw64(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | uint64_t(1) << 16 | uint64_t(512 >> 4) << 32 |
         uint64_t(2) << 62;
}

// A map over a `rank`-d tensor of `type` (dims[0] contiguous; bytes[i] the
// stride of dimension i + 1, a multiple of 16); a box is box[0] x ... x
// box[rank - 1] in the given swizzle, and what lies past the tensor reads as
// zeros (and is not written by a store).
CUresult make_map_nd(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rank,
                     const uint64_t* dims, const uint64_t* bytes, const uint32_t* box,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], unit[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    unit[i] = 1;
    if (i + 1 < rank) st[i] = bytes[i];
  }
  return encode(map, type, cuuint32_t(rank), const_cast<void*>(ptr), d, st, bx, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A map over a row-major (rows, cols) matrix of `type` with `row_bytes`
// between rows; a box is box_cols x box_rows in the given swizzle, and what
// lies past the matrix reads as zeros.
CUresult make_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rows,
                     int cols, uint64_t row_bytes, int box_cols, int box_rows,
                     CUtensorMapSwizzle swizzle) {
  const uint64_t dims[2] = {uint64_t(cols), uint64_t(rows)};
  const uint32_t box[2] = {uint32_t(box_cols), uint32_t(box_rows)};
  return make_map_nd(map, type, ptr, 2, dims, &row_bytes, box, swizzle);
}

// ------------------------------------------- the RS products of the GEMMs
// D (64 x 128, s32) (+)= A (64 x 32 s8, registers) B (128 x 32 s8, shared
// memory, K-major)
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 256, s32) (+)= A (64 x 32 s8, registers) B (256 x 32 s8, shared
// memory, K-major)
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]),
        "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]),
        "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 64, fp32) (+)= A (64 x 16 bf16, registers) B (64 x 16 bf16, shared
// memory, K-major: imm-trans-b 0)
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 128, fp32) (+)= A (64 x 16 bf16, registers) B (128 x 16 bf16, shared
// memory, K-major: imm-trans-b 0)
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 152, fp32) (+)= A (64 x 16 bf16, registers) B (152 x 16 bf16, shared
// memory, K-major: imm-trans-b 0)
__device__ __forceinline__ void wgmma_bf16_n152(float (&d)[76], const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %81, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75"
      "}, {%76, %77, %78, %79}, %80, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 208, fp32) (+)= A (64 x 16 bf16, registers) B (208 x 16 bf16, shared
// memory, K-major: imm-trans-b 0)
__device__ __forceinline__ void wgmma_bf16_n208(float (&d)[104], const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %109, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n208k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103"
      "}, {%104, %105, %106, %107}, %108, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D (64 x 256, fp32) (+)= A (64 x 16 bf16, registers) B (256 x 16 bf16, shared
// memory, K-major: imm-trans-b 0)
__device__ __forceinline__ void wgmma_bf16_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  if constexpr (N == 64) wgmma_bf16_n64(d, a, db, accumulate);
  else if constexpr (N == 128) wgmma_bf16_n128(d, a, db, accumulate);
  else if constexpr (N == 152) wgmma_bf16_n152(d, a, db, accumulate);
  else if constexpr (N == 208) wgmma_bf16_n208(d, a, db, accumulate);
  else wgmma_bf16_n256(d, a, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (N == 128) wgmma_s8_n128(d, a, db, accumulate);
  else wgmma_s8_n256(d, a, db, accumulate);
}

// ------------------- the SS products of the convs and of the flash forward's int8 QK^T
// D (64 x 64, s32) (+)= A (64 x 32 s8) B (64 x 32 s8), both in shared memory,
// K-major
__device__ __forceinline__ void wgmma_s8_ss_n64(int (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, s32) (+)= A (64 x 32 s8) B (128 x 32 s8), both in shared memory,
// K-major
__device__ __forceinline__ void wgmma_s8_ss_n128(int (&d)[64], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 160, s32) (+)= A (64 x 32 s8) B (160 x 32 s8), both in shared memory,
// K-major
__device__ __forceinline__ void wgmma_s8_ss_n160(int (&d)[80], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]),
        "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 256, s32) (+)= A (64 x 32 s8) B (256 x 32 s8), both in shared memory,
// K-major
__device__ __forceinline__ void wgmma_s8_ss_n256(int (&d)[128], uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]),
        "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]),
        "+r"(d[119]), "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_s8_ss(int (&d)[N / 2], uint64_t da, uint64_t db,
                                            int accumulate) {
  if constexpr (N == 64) wgmma_s8_ss_n64(d, da, db, accumulate);
  else if constexpr (N == 128) wgmma_s8_ss_n128(d, da, db, accumulate);
  else if constexpr (N == 160) wgmma_s8_ss_n160(d, da, db, accumulate);
  else wgmma_s8_ss_n256(d, da, db, accumulate);
}

// ------------------------------------------------------- the persistent core
namespace gemm {

constexpr int BK = 64;               // K elements a stage
constexpr uint32_t SMEM_MAX = 232448;  // what a block can opt into

constexpr int CLUSTER = 2;          // blocks a cluster: x is loaded once for both

// The walk: a unit is the two tiles of a cluster, which read the same x; unit
// u is (uo, ui) = (u / unit_inner, u % unit_inner), and block `rank` of the
// cluster takes tile (uo, 2 ui + rank) when pair_inner, else (2 uo + rank,
// ui). Cluster c of gridDim.x / 2 takes units c, c + gridDim.x / 2, ...
struct Walk {
  int unit_inner, units, k_blocks, pair_inner;
};

__device__ __forceinline__ void tile_of(const Walk& w, int u, int rank, int& outer, int& inner) {
  const int uo = u / w.unit_inner, ui = u - uo * w.unit_inner;
  outer = w.pair_inner ? uo : 2 * uo + rank;
  inner = w.pair_inner ? 2 * ui + rank : ui;
}

// A consumer thread: its warpgroup (0, 1), warp in it, lane / 4, lane % 4
struct Thread {
  int tid, wg, warp, lane, g, t;
};

// Done with a stage: one arrival a warp on the stage's empty barrier of both
// blocks of the cluster (each block's TMA writes into both).
__device__ __forceinline__ void release(uint32_t empty_bar, const Thread& th) {
  __syncwarp();
  if (th.lane == 0)
#pragma unroll
    for (int r = 0; r < CLUSTER; ++r) bar_arrive_remote(empty_bar, r);
}

// The largest ring (at most 6 stages) that fits beside the two staging tiles
// and the barriers.
constexpr int stages_that_fit(uint32_t stage_bytes, uint32_t out_bytes) {
  const uint32_t room = (SMEM_MAX - 1024 - 2 * out_bytes - 16 * 6 - 16) / stage_bytes;
  return room > 6 ? 6 : int(room);
}

// Where things lie in a block's shared memory, from its 1,024-byte aligned
// base: the ring of STAGES, the two warpgroups' staging tiles, then the
// ring's full and empty barriers and the warpgroups' own barriers. Ring index
// i is stage i % STAGES.
template <class S>
struct Layout {
  static constexpr int ST = S::STAGES;
  static constexpr uint32_t STAGING = ST * S::STAGE_BYTES;
  static constexpr uint32_t BARS = STAGING + 2 * S::OUT_BYTES;
  static constexpr uint32_t BYTES = 1024 + BARS + 16 * ST + 16;
  static_assert(BYTES <= SMEM_MAX, "shared memory above what a block can opt into");
  uint32_t base;
  __device__ uint32_t stage(int i) const { return base + uint32_t(i % ST) * S::STAGE_BYTES; }
  __device__ uint32_t full(int i) const { return base + BARS + 8u * uint32_t(i % ST); }
  __device__ uint32_t empty(int i) const { return base + BARS + 8u * uint32_t(ST + i % ST); }
  __device__ uint32_t aux(int wg) const { return base + BARS + 16u * ST + 8u * uint32_t(wg); }
};

// A consumer warpgroup's staging tile (S::OUT_BYTES at `out`), its own
// barrier (arrival count 1) and the tiles it ran before the current one, as
// the spec's `prefetch` sees them when a tile begins.
struct Staging {
  uint32_t out, aux;
  int n;
};

// The A fragments of every k-step of one stage.
template <class S>
__device__ __forceinline__ void build_stage(uint32_t (&f)[S::SPS][4], uint32_t st,
                                            const typename S::Params& p, const Thread& th) {
#pragma unroll
  for (int s = 0; s < S::SPS; ++s) S::build(f[s], st, s, p, th);
}

// One stage's products, issued as one group.
template <class S>
__device__ __forceinline__ void issue_stage(typename S::Acc& acc, uint32_t (&f)[S::SPS][4],
                                            uint32_t st, bool first) {
  pin(acc);
  pin(f);
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < S::SPS; ++s) S::mma(acc, f[s], st, s, !first || s > 0);
  wgmma_commit();
}

// One tile's products: the stages of k blocks it .. it + k_blocks - 1 of the
// ring. The fragments of stage kb + 1 are built while the group of stage kb
// runs (two fragment sets); a stage is released once its group completed.
template <class S>
__device__ __forceinline__ void mainloop(typename S::Acc& acc, const typename S::Params& p,
                                         const Layout<S>& L, int& it, const Thread& th) {
  constexpr int ST = S::STAGES;
  const int k_blocks = p.walk.k_blocks;
  uint32_t f[2][S::SPS][4];
  // k block kb (fragments in f[cur]): issue it, wait for block kb - 1's group,
  // release that stage, build block kb + 1 into f[cur ^ 1]
  const auto step = [&](int kb, uint32_t (&cur)[S::SPS][4], uint32_t (&nxt)[S::SPS][4]) {
    const int i = it + kb;
    issue_stage<S>(acc, cur, L.stage(i), kb == 0);
    wgmma_wait<1>();
    pin(acc);
    if (kb > 0) release(L.empty(i - 1), th);
    if (kb + 1 < k_blocks) {
      bar_wait(L.full(i + 1), ((i + 1) / ST) & 1);
      build_stage<S>(nxt, L.stage(i + 1), p, th);
    }
  };
  bar_wait(L.full(it), (it / ST) & 1);
  build_stage<S>(f[0], L.stage(it), p, th);
  for (int kb = 0; kb < k_blocks; kb += 2) {
    step(kb, f[0], f[1]);
    if (kb + 1 < k_blocks) step(kb + 1, f[1], f[0]);
  }
  wgmma_wait<0>();
  pin(acc);
  release(L.empty(it + k_blocks - 1), th);
  it += k_blocks;
}

// The SS form: both operands by descriptor. Stage kb's products are issued
// once it has landed; then the group of stage kb - 1 is waited for and that
// stage released, so at most two groups are in flight.
template <class S>
__device__ __forceinline__ void mainloop_ss(typename S::Acc& acc, const typename S::Params& p,
                                            const Layout<S>& L, int& it, const Thread& th) {
  constexpr int ST = S::STAGES;
  const int k_blocks = p.walk.k_blocks;
  for (int kb = 0; kb < k_blocks; ++kb) {
    const int i = it + kb;
    bar_wait(L.full(i), (i / ST) & 1);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < S::SPS; ++s) S::mma(acc, L.stage(i), s, kb > 0 || s > 0, th);
    wgmma_commit();
    wgmma_wait<1>();
    pin(acc);
    if (kb > 0) release(L.empty(i - 1), th);
  }
  wgmma_wait<0>();
  pin(acc);
  release(L.empty(it + k_blocks - 1), th);
  it += k_blocks;
}

// The kernel's body (smem as Layout<S> lays it out).
template <class S>
__device__ __forceinline__ void run(const typename S::Params& p) {
  constexpr int ST = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const Layout<S> L{(raw + 1023u) & ~1023u};
  const Walk& w = p.walk;
  const int rank = int(cluster_rank());
  const int cluster = blockIdx.x / CLUSTER, clusters = gridDim.x / CLUSTER;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      bar_init(L.full(s), 1);  // the producer, with the TMA bytes of both blocks
      bar_init(L.empty(s), CLUSTER * CONSUMERS / 32);  // each consumer warp of both blocks
    }
    bar_init(L.aux(0), 1);
    bar_init(L.aux(1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both blocks' barriers are ready before either's TMA or arrivals

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: its first thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == CONSUMERS) {
      int it = 0;
      for (int u = cluster; u < w.units; u += clusters) {
        int outer, inner;
        tile_of(w, u, rank, outer, inner);
        for (int kb = 0; kb < w.k_blocks; ++kb, ++it) {
          bar_wait(L.empty(it), ((it / ST) & 1) ^ 1);  // passes at once on the first round
          bar_arrive_expect_tx(L.full(it), S::STAGE_BYTES);
          S::load(p, L.stage(it), L.full(it), outer, inner, kb, rank);
        }
      }
    }
  } else {
    // ---- consumer warpgroups 0 and 1
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    Thread th;
    th.tid = threadIdx.x & 127;
    th.wg = threadIdx.x >> 7;
    th.warp = th.tid >> 5;
    th.lane = threadIdx.x & 31;
    th.g = th.lane >> 2;
    th.t = th.lane & 3;
    const uint32_t out = L.base + Layout<S>::STAGING + th.wg * S::OUT_BYTES;
    typename S::Acc acc;
    int it = 0, n = 0;
    for (int u = cluster; u < w.units; u += clusters, ++n) {
      int outer, inner;
      tile_of(w, u, rank, outer, inner);
      // the epilogue's per-column values, loaded now, in use after the products
      const typename S::Pre pre = S::prefetch(p, outer, inner, th, Staging{out, L.aux(th.wg), n});
      if constexpr (S::SS)
        mainloop_ss<S>(acc, p, L, it, th);
      else
        mainloop<S>(acc, p, L, it, th);
      // the warpgroup's staging tile is free once its last TMA store read it
      if (th.tid == 0) bulk_wait_read();
      sync_warpgroup(1 + th.wg);
      S::stage_out(acc, pre, out, p, outer, inner, th);
      fence_async_smem();
      sync_warpgroup(1 + th.wg);
      if (th.tid == 0) {
        S::store(p, out, outer, inner, th.wg);
        bulk_commit();
      }
    }
    if (th.tid == 0) bulk_wait();  // the stores are done before the block's memory goes
  }
  cluster_sync();  // neither block leaves while the other may still write into it
}

// Clusters of this kernel that fit on the card at once (0 if the query fails).
template <class Kernel>
int max_clusters(Kernel kernel, uint32_t smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER * 1024);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) == cudaSuccess ? n : 0;
}

}  // namespace gemm

}  // namespace wg

}  // namespace
