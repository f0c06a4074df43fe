// The weight ring of K1's streamed layouts (Cfg's with kStream in
// convnext_block.cuh, the wide class's WCfg in convnext_wide.cuh): W2 and W3
// arrive in chunks of E channels, each chunk (its W2 rows, then its W3
// columns) one contiguous range of device memory that the wrapper arranged
// in the order and padding the kernel reads
// (pallas_convnext.kernel_operands). A chunk lands in one of NS stages of
// shared memory by a bulk copy (cp.async.bulk, the Tensor
// Memory Accelerator's copy of a contiguous range) that complete on the
// stage's "full" mbarrier; the consumers wait there and, done with the
// stage, arrive on its "empty" mbarrier, which one thread waits on before
// it refills the stage. On a thread-block cluster of NCL blocks (on
// neighbouring tiles) every block takes the same chunks in the same order:
// block r copies its 1/NCL of the range with .multicast::cluster into the
// stage of every block of the cluster and counts the whole chunk's bytes on
// its own full barrier, and each consumer warp arrives on the empty barrier
// of every block (mapa; lane r on block r's), so a stage is refilled only
// once every block of the cluster is done with it. The L2 then reads each
// chunk once for NCL blocks.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bid_ring {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the barriers' initialisation visible to the cluster's other blocks (and
// to the async proxy) before any of them arrives on one
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive on the barrier and expect `bytes` more of its transactions
__device__ __forceinline__ void arrive_expect_tx(uint32_t bar,
                                                 uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait for the phase of parity `parity` of a barrier (completed by this
// block's copies and the cluster's multicast into it, or by the cluster's
// warps' arrivals)
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "RING_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra RING_WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// arrive on the barrier at this block's shared address `bar` in block
// `cta` of the cluster. The default semantics (release at the CTA's
// scope), as CUTLASS's pipelines release a stage: a warp's reads of the
// stage are done (their values in registers) before it arrives. With
// .release.cluster here and .acquire.cluster on the producer's wait the
// ring landed 2.0 TB/s against 13.0 (k1_compare.py --l2-rate, PERF.md §6)
__device__ __forceinline__ void arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void arrive_local(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// `bytes` (a multiple of 16, both addresses on 16 bytes) from device memory
// into this block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// the same into the shared memory of every block of `mask` at the same
// offset, completing on each one's barrier at `bar`'s offset
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
      "multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// every thread of the cluster's blocks (NCL = 1: of the block) meets here
template <int NCL>
__device__ __forceinline__ void sync_cluster() {
  if constexpr (NCL > 1)
    cooperative_groups::this_cluster().sync();
  else
    __syncthreads();
}

// this block's rank in its cluster of NCL blocks
template <int NCL>
__device__ __forceinline__ int cluster_rank() {
  if constexpr (NCL > 1)
    return (int)cooperative_groups::this_cluster().block_rank();
  else
    return 0;
}

// NS stages of a chunk of STAGE bytes each on a cluster of NCL blocks;
// chunk g of a block's running count lands in stage g % NS
template <int NS, int NCL, uint32_t STAGE>
struct ChunkRing {
  static_assert(NS >= 2 && NCL >= 1 && NCL <= 8, "a ring of stages");
  static_assert(STAGE % (16 * NCL) == 0,
                "each block's slice of a chunk is whole 16-byte units");
  // bars: the 2 NS mbarriers, full then empty; stages: stage 0
  uint32_t bars, stages;

  __device__ __forceinline__ ChunkRing(const void* bar_mem,
                                       const void* stage_mem)
      : bars(smem_addr(bar_mem)), stages(smem_addr(stage_mem)) {}

  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (NS + s);
  }
  __device__ __forceinline__ uint32_t stage(int s) const {
    return stages + (uint32_t)s * STAGE;
  }

  // one thread, before any use: a full barrier takes its producer's
  // arrival (and the bytes), an empty one a release from every consumer
  // warp of the cluster. The caller then meets the cluster (sync_cluster)
  __device__ __forceinline__ void init(int warps) const {
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), (uint32_t)(NCL * warps));
    }
    fence_mbar_init();
  }

  // one thread: chunk g of the running count, STAGE bytes at src in
  // device memory, into stage g % NS once every consumer of the cluster
  // has released that stage's last chunk; on a cluster, this block's
  // 1/NCL of it multicast
  __device__ __forceinline__ void issue(int g, const unsigned char* src) const {
    const int s = g % NS;
    if (g >= NS) wait_parity(empty(s), (uint32_t)((g / NS - 1) & 1));
    arrive_expect_tx(full(s), STAGE);
    if constexpr (NCL > 1) {
      constexpr uint32_t PART = STAGE / NCL;
      const uint32_t o = (uint32_t)cluster_rank<NCL>() * PART;
      bulk_copy_multicast(stage(s) + o, src + o, PART, full(s),
                          (uint16_t)((1u << NCL) - 1));
    } else {
      bulk_copy(stage(s), src, STAGE, full(s));
    }
  }

  // every consumer: wait until chunk g has landed in its stage
  __device__ __forceinline__ void wait(int g) const {
    wait_parity(full(g % NS), (uint32_t)((g / NS) & 1));
  }

  // a warp, every lane: done with chunk g's stage (lane r arrives on the
  // stage's empty barrier of block r)
  __device__ __forceinline__ void release(int g, int lane) const {
    __syncwarp();
    if constexpr (NCL > 1) {
      if (lane < NCL) arrive_cluster(empty(g % NS), (uint32_t)lane);
    } else {
      if (lane == 0) arrive_local(empty(g % NS));
    }
  }
};

}  // namespace bid_ring
