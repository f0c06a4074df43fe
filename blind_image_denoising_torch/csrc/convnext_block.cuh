// One ConvNext residual unit at inference, fused:
//   t = LN(depthwise_KxK(x)) (f32 stats, eps 1e-3, scale only)
//   h = leaky_relu(W2 t, slope)   1x1, C -> E = 4C
//   p = W3 h                      1x1, E -> C
//   out = x + gain * p
//
// Replaces blind_image_denoising_tpu/ops/pallas_convnext.py
// fused_convnext_block (body _block_kernel), float and int8 I/O modes.
// NHWC in and out. Bound: bytes in bf16, the CUDA-core operations in int8,
// the three TF32 passes of the products in f32
// (blind_image_denoising_torch/ops/pallas_convnext.py has the counts); in
// practice the bf16 and int8 kernel is bound by its instruction count
// against the warp schedulers' rate, about half of it the depthwise sum's,
// so the design spends as few instructions as it can there and keeps the
// schedulers fed:
// * persistent blocks walk over tiles of 8 x 32 output pixels of one image;
//   the weights are staged into shared memory once per block;
// * the input tile plus its K/2 halo arrives by 16-byte cp.async copies whose
//   source size is 0 outside the image, so the hardware writes the SAME
//   padding's zeros. bf16 I/O has two tile buffers: the copies of tile n+1
//   are started before tile n's depthwise and waited for at the top of the
//   next turn, so no warp waits on device memory. int8 I/O copies the raw
//   codes of tile n+1 into a staging buffer while tile n is computed, and a
//   pass after the wait dequantizes them into the one bf16 tile as
//   bf16(q * bf16(scale_in)) (the product is exact in f32, so this is the JAX
//   kernel's one bf16 rounding);
// * depthwise + LayerNorm (bf16 tile): a thread owns one 16-byte channel
//   group (8 channels) of R = 4 neighbouring output pixels of a row. Per tap
//   row it loads its K x 8 f32 weights and the R + K - 1 input vectors once
//   each, converts each once and does the R*K*8 FMAs from registers (1.6
//   instructions per FMA; one thread per pixel over all channels took 2.9);
//   K = 7's own layouts take runs of two rows instead (below);
//   The C/8 threads of a pixel are neighbouring lanes: mean and centred
//   variance (two passes, f32) are butterfly sums over them, and each thread
//   writes its 8 channels of t as one 16-byte bf16 store;
// * each warp then runs both 1x1 products for 16 pixels at a time with
//   mma.sync m16n8k16 (bf16 operands, f32 accumulation), its A and B
//   fragments loaded by ldmatrix, two mma's operands per instruction. The
//   expansion's accumulators, leaky-ReLU'd and rounded to bf16, are the
//   projection's A fragments in registers (chunks of 64 of the E channels,
//   32 at C = 64), so h never leaves the registers. The warp adds
//   x + gain * p (int8: requantizes with
//   __float2int_rn(out * f32(1/scale_out)), round half to even like
//   jnp.round, clamped to +-127) into its own rows of the t tile and writes
//   them to device memory with 16-byte stores, so a tile costs two block
//   barriers (three in int8);
// * threads and shared memory: C = 32 runs 256 threads and two blocks per SM
//   (16 warps; (32,5) bf16: weights 22,400 B + 2 x 34,560 B tiles + 20,480 B
//   t = 112,000 B). At C = 64 the bf16 W2 and W3 alone are 70,656 B, so one
//   block of 512 threads (16 warps) owns the SM: weights 77,568 B + 2 x
//   55,296 B tiles + 36,864 B t = 225,024 B of the 232,448 B a block may
//   have. That fits only with unpadded 128-byte pixel rows in the tile, so
//   there the 16-byte chunks of a pixel are XOR-swizzled by its column
//   (chunk ^ (column & 7)): the depthwise reads (8 lanes, one pixel, all
//   chunks) and the epilogue's (8 lanes, 8 neighbouring pixels, one chunk)
//   both stay free of bank conflicts. At C = 32 the rows are padded to 80
//   bytes instead (two runs 4 pixels apart fall into opposite halves of the
//   128-byte bank line).
//
// f32 I/O keeps float32 accuracy and runs the two products, 95% of its
// operations, on the tensor cores as error-compensated 3xTF32: each operand
// v is split into big = v rounded to TF32 and small = v - big (exact), and
// D += small.big + big.small + big.big with mma.sync m16n8k8 (TF32, f32
// accumulation), small.small dropped; the tensor core reads the top 19 bits
// of each operand, so small is passed as it is. Rounding of big, at the
// integer rate (cvt.rna.tf32.f32 runs at the conversion rate, a quarter of
// it): t and h, once per pixel and step, to nearest with ties away from
// zero ((bits + 0x1000) & ~0x1fff); the weights, split on every load,
// truncated (bits & ~0x1fff, which the compiler folds into the tensor
// core's own truncation, so a weight costs a LOP and an FADD for its small
// part). Truncation raises the error 1.1-1.7x over rounding to nearest;
// either way it is about 1e-6 of max |out|. The least time is the three
// passes over the TF32 rate; mma.sync's TF32 rate (2/3 of the dense peak
// on the H100: python3 k1_compare.py --mma-rate) and the splits'
// instructions cap what is reached.
// * tiles of 8 x 16 pixels, 256 threads: warp w owns tile row w, one m16
//   tile of the products. Lane (g = lane / 4, q = lane % 4) owns pixels 2g
//   and 2g + 1 (the m16 tile's rows g and g + 8) and, of each 16 channels,
//   the 4 at 4q. Depthwise: per group and tap row it loads the K weight and
//   K + 1 input vectors once and does the 2K x 4 FMAs from registers; the 4
//   lanes of a pixel pair share the LayerNorm's two-pass statistics by
//   shuffles. t and the pixels' own x stay in registers;
// * the product's k order is free, so channel 16i + 4q + r is the k index
//   of the lane's A fragments of k-steps 2i (r = 0, 1) and 2i + 1 (r = 2,
//   3): t in registers is the expansion's A operand as it stands. m16n8k8's
//   accumulator holds columns 2q, 2q + 1 where its A operand wants q, q + 4,
//   so W3's E index is permuted within each group of 8 as [0,2,4,6,1,3,5,7]
//   when staged: then the expansion's accumulators d0..d3, leaky-ReLU'd in
//   f32 and split, are the projection's A fragment d0, d2, d1, d3, and h
//   (32 E channels a step at C = 64, 16 at C = 32, where two blocks of 8
//   warps share an SM's registers) never leaves the registers. W3's output
//   rows are permuted the same way, so a lane's projection accumulators are
//   its own pixels' channels 16i + 4q .. + 3: the epilogue adds them to x
//   with __fadd_rn(x, __fmul_rn(gain, p)) and stores 16 bytes a pixel and
//   group;
// * W2 and W3 stay float32 in shared memory in fragment order (one warp's B
//   operands of two n8 tiles are 512 contiguous bytes, read by LDS.128 free
//   of bank conflicts) and are split as they are loaded: split weights would
//   double both the bytes (2 x 131,072 B at C = 64) and the shared-memory
//   reads a product needs;
// * pixel rows of the tile are padded by 32 bytes, so the two lane quads of
//   a quarter-warp (pixels two apart) fall into opposite halves of the bank
//   line. (32, K): two 16-byte-aligned tile buffers, the copies of tile n+1
//   in flight while tile n is computed, 2 blocks of 8 warps per SM ((32,5):
//   3,456 B depthwise, LN and gain + 2 x 38,400 B tiles + 32,768 B W2 and W3
//   = 113,024 B). (64,5): W2 and W3 are 131,072 B and two 69,120 B tiles do
//   not fit, so there is one, and the copies of tile n+1 into it start once
//   every warp has done its depthwise, overlapping the products: 6,912 +
//   69,120 + 131,072 = 207,104 B, one block of 8 warps. (64,1) has two tiles
//   of 36,864 B (205,568 B). No atomics: the same inputs give the same bits.
//
// C = 128 (the level-2 units of unet_laplacian_v3 / v4, the fused level 2
// of a depth-4 unet_laplacian_v6): W2 and W3 (272,384 B in bf16, 524,288 B
// in f32) do not fit beside a tile, so they stream through a ring of NS
// stages of E chunks (chunk_ring.cuh): ECH = 32 of the E channels a chunk
// (W2's rows, W3's matching columns; 18,944 B in bf16, 32,768 B in f32),
// 16 where three of 32 do not fit (f32 (128, 5); int8 (128, 7) beside its
// staged codes), as many stages as fit up to four (three at least). The
// wrapper lays each chunk out in device memory as its stage holds it
// (kernel_operands: padded bf16 rows, f32 fragment order), so a chunk is
// one contiguous range and one thread issues it as a bulk copy
// (cp.async.bulk) that completes on the stage's full mbarrier. Two blocks
// on neighbouring tiles form a thread-block cluster: each copies half of
// every chunk multicast into both blocks' stage, and each warp, done with
// a stage, arrives on its empty barrier in both blocks; thread 0 refills a
// stage NS - 1 chunks ahead once every warp of the cluster has released
// it. No block barrier a chunk: a warp waits only for its chunk to land.
// The chunks run on from tile to tile (the next tile's first ones land
// under the last products); a block of the cluster left without a tile in
// the last round takes a ghost tile (rows past the image, stored nowhere)
// so that both take every chunk. Every mode takes 8 x 16 tiles with 256
// threads, one m16 tile a warp and one block an SM: bf16 (128,5) 13,824 B
// depthwise, LN and gain + 2 x 61,440 B swizzled tiles + 3 x 18,944 B
// stages + 34,816 B t + 64 B of mbarriers = 228,416 B (int8 216,640 B, one
// tile, the 30,720 B of codes and 4 stages); f32 (128,5) one 130,560 B tile
// + 4 x 16,384 B stages = 209,984 B; f32 (128,7), whose 167,552 B tile
// leaves no room for three stages, lends the tile's room to the ring from
// its depthwise to its epilogue (the cluster meets before the first chunk:
// kRingInX). bf16 and int8: a warp's A fragments of t (32 registers) and
// its projection accumulators (64) stay in registers across the chunks.
// f32: the chunks are in fragment order (expand_project_f32: a lane's B
// operands of two k-steps of one n8 tile are one 16-byte vector), the
// accumulators (64 registers) stay in registers and t waits in the tile
// buffer's room (each lane its own 64 values; t in registers too spilled
// 12-40 bytes at 255), the residual x is read back from device memory,
// the one tile buffer is refilled once the epilogue is done, and a chunk's
// two 16-channel steps are not unrolled into each other. At C = 128 the
// unit does 512 operations a byte of bf16 I/O, above the card's ridge: it
// is bound by its products, which mma.sync runs at about 2/3 of the tensor
// cores' dense rate.
//
// Those seven (C, K), and (64, 3) and (128, 3) in the same layouts (the K = 3
// halo is smaller than the K = 5 one), and (32, 7), (64, 7), (128, 7) have
// instantiations of their own (convnext_block.cu; K = 7 in convnext_k7.cu,
// a source of its own so that it builds beside the others). K = 7 (the flax ConvNext
// layer's default kernel size) grows the halo to 3 a side: the layouts
// stay, and the rules above pick what fits: bf16 (64, 7) (188,672 B) and
// (128, 7) keep one tile buffer, and so does bf16 (32, 7), so that two
// blocks share an SM (88,512 B; int8 105,536 B, two blocks too; two tile
// buffers, 131,072 B, held one block of 8 warps). Each warp of the three
// moves its pixels' residual x into its own t rows once it has its A
// fragments from them, and once every warp has, the next tile is copied
// into the buffer under the products and the epilogue (kResT,
// residual_to_t; refilled once every epilogue was done, (64, 7) read 4-5%
// slower); f32 (64, 7) streams W2 and W3 as C = 128 does (its 131,072 B no
// longer fit beside a 88,704 B tile) and keeps two tiles; f32 (128, 7)
// lends its tile's room to the ring. The bf16 depthwise of K = 7's own
// layouts (int8's dequantized tile too) gives a thread 4 channels of two
// rows of R pixels (depthwise_layernorm_rows2): each input row it needs is
// loaded and converted once and feeds both output rows, and each tap
// row's weights are loaded once for both, so a FMA costs 1.44-1.51
// instructions with the LayerNorm (PERF.md), against 1.51-1.61 for the
// depthwise alone when each thread walked the K tap rows of one row of
// pixels, as the class widths still do.
// Every other C from 1 to 256 at K = 1, 3, 5 or 7 (E = 4C) runs a class of
// width CW with the true C a launch argument (kRagged):
// * CW = C rounded up to 16 for C <= 128 (convnext_class.cuh; its widths
//   built over seven sources): the layouts above written for any width that
//   is a multiple of 16, so a unit pays for about C channels of depthwise
//   and C' x 4C' of each product (C' = CW), not for the next of 32, 64,
//   128 (float32 from C = 97 to 112 keeps 128: its width-112 layout
//   spilled). Cfg's rules pick each width's layout from the budget: tiles of
//   8 x 32 in bf16 at CW <= 32, and at 64 and (48, 7) with one block of
//   512 threads an SM, else 8 x 16 (one m16 tile a warp);
//   W2 and W3 resident where their padded bf16 rows take at most half of a
//   block's shared memory (up to CW = 80: 108,800 B) and streamed in
//   chunks of 32 E channels from CW = 96; two blocks an SM wherever two fit
//   with resident weights at K < 7 (CW <= 32; bf16 and int8 at 48); tile
//   rows swizzled at CW = 64, 128 and padded by 16 bytes elsewhere. The
//   depthwise's CW / 8 lanes a run share a warp, 32 / (CW / 8) runs a warp
//   round (CW = 48, 80, 96, 112 leave 2, 2, 8, 4 lanes a warp idle), and
//   the LayerNorm's sums over them are segmented shuffles (segment_sum);
//   an odd number of k16 steps (CW = 16, 48, 80, 112) ends the expansion
//   on an ldmatrix.x2. The wrapper pads dw, the LayerNorm scale, the gain,
//   W2's columns and W3's rows with zeros to CW and E to 4 CW, so a padded
//   channel's depthwise sum, t and expansion rows are 0 (leaky(0) = 0) and
//   add nothing to either product; the LayerNorm's mean and variance are
//   taken over the true C (a padded channel's centred value is masked to
//   0). Copies (RaggedIO, from cr): int8 copies the tile's rows
//   as they lie in device memory (a tile row's pixels inside the image are
//   one contiguous run) by 16-byte cp.async into its stage, and a pass
//   dequantizes each pixel's 8-channel groups into the tile, zeros past C;
//   bf16 and f32 copy each pixel's row in units of the largest power of two
//   up to 16 bytes that divides it (16 bytes where the row allows) into
//   tile buffers cleared once a launch, walking its (pixel, unit) pairs
//   with no division. The epilogue writes a warp's 16 pixels (one
//   contiguous run) packed as in device memory into its t rows and stores
//   the run in 16-byte units, its ends in pieces (store_rows_ragged); f32
//   stores 16 bytes a lane and group where C % 4 == 0;
// * CW = 256 for 128 < C <= 256 (convnext_wide.cu; WCfg in
//   convnext_wide.cuh): tiles of 8 x 8 pixels, 256 threads, one block an SM.
//   The projection's accumulators of 16 pixels x 256 channels would be 128
//   registers a lane, so warps 2m and 2m + 1 share m16 tile m, 128 output
//   channels each. W2 and W3 stream through the ring as at C = 128, in
//   chunks of 16 E channels (three stages of 32 do not fit beside a whole
//   (256, 5) tile), on a cluster of two blocks; of a chunk each warp of the
//   pair computes one n8 tile of the expansion (bf16: from its A fragments
//   of t in registers) and hands its h to the other through a
//   shared-memory block of 16 x ECH (a named barrier of the pair's 64
//   threads; two sets of blocks, by the chunk's parity, so that one
//   chunk's writes wait for no reader of the last), and each projects the
//   whole chunk's h onto its 128 channels. The residual x is read back
//   from device memory, so the one input tile that (256, 5) leaves room
//   for is refilled once every warp is past its depthwise (bf16; two
//   tiles at K <= 3); int8 stages the next tile's codes in the t tile's
//   room once its epilogue is done;
// * grouped (K = 7 at CW = 256, and f32 at every K): a whole-C tile does
//   not fit (14 x 14 x 256 bf16 with K = 7's halo is 100,352 B, 12 x 12 x
//   256 f32 147,456 B), so the depthwise runs by groups of 64 channels:
//   each group's input (in the I/O type; int8 codes dequantized as they
//   are read) and its depthwise weights are copied into a slot,
//   double-buffered, and the raw f32 sums of the whole tile go to shared
//   memory (f32: into t itself), a LayerNorm pass (a warp a pixel) writes
//   t, and only then do W2 and W3 stream: the slots and the raw sums
//   share their room with the ring, so the cluster's blocks meet after
//   their LayerNorms, the tile's first chunks are issued then, and the
//   next tile's first group is copied after the epilogue (bf16 (256, 7)
//   183,872 B; f32 227,392 B at every K). f32 keeps t in shared memory; its
//   products read their A fragments from t and h there (rows padded by 4
//   floats: free of bank conflicts) and run as 3xTF32 as above.
// Above C = 256 (up to 1024) a thread-block cluster of ceil(C / 128)
// blocks runs the unit instead, each block owning 128 of the output
// channels and 512 of the E channels, the channels padded to 128 a block
// (convnext_cluster.cuh has the design; convnext_cluster.cu,
// convnext_cluster_int8.cu and convnext_cluster_f32.cu build it).
#pragma once

#include <limits.h>

#include <type_traits>

#include "chunk_ring.cuh"
#include "common.cuh"

namespace {

using bid::bf16;

constexpr float kLnEps = 1e-3f;

constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// the entry points' dtype code of an I/O type: 0 float32, 1 bfloat16, 2 int8
template <typename T>
constexpr int dtype_code() {
  return std::is_same<T, float>::value ? 0
         : std::is_same<T, bf16>::value ? 1
                                        : 2;
}

// dynamic shared memory one block may have on an H100, and one SM's (a
// block also takes 1 KB of it for itself)
constexpr size_t kMaxSmem = 232448;
constexpr size_t kSmemPerSm = 233472;
constexpr size_t kSmemPerBlock = 1024;

// the streamed layouts' weight ring (chunk_ring.cuh): clusters of
// kRingCluster blocks on neighbouring tiles, each chunk multicast to both;
// as many stages as fit, up to kRingStages (at least three); its
// mbarriers' bytes
constexpr int kRingCluster = 2;
constexpr int kRingStages = 4;
constexpr size_t kRingBars = 16 * kRingStages;

// I/O type T; S is the type of the shared input tile and of the 1x1 weights
// (int8 codes are dequantized into a bf16 tile). RAGGED_: the layout of
// width C (a multiple of 16), for any true C from C - 15 to C (a launch
// argument)
template <typename T, int C_, int K_, bool RAGGED_ = false>
struct Cfg {
  static_assert(C_ % 16 == 0 && C_ <= 128, "layouts of widths 16 .. 128");
  using S = std::conditional_t<std::is_same<T, float>::value, float, bf16>;
  static constexpr int C = C_, K = K_, E = 4 * C_, PAD = K_ / 2;
  static constexpr bool kRagged = RAGGED_;
  // the two products on bf16 operands (bf16 and int8 I/O); f32 I/O runs
  // them in 3xTF32
  static constexpr bool kMma = std::is_same<S, bf16>::value;
  static constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  // bf16: one block of 512 threads an SM on 8 x 32 tiles where the width
  // holds one block (C = 64; 48 at K = 7, where two blocks of 8 x 16
  // tiles do not fit: 16 warps an SM, not 8); tiles of 8 x 32 pixels and
  // 256 threads at C <= 32 (two blocks an SM), else 8 x 16 (one m16 tile a
  // warp of 256 threads)
  static constexpr bool kBlock512 = kMma && (C == 64 || (C == 48 && K == 7));
  static constexpr int TH = 8, TW = kMma && (C <= 32 || kBlock512) ? 32 : 16;
  static constexpr int P = TH * TW;          // pixels per tile
  // threads per block (f32: a warp per tile row)
  static constexpr int NT = !kMma ? 32 * TH : kBlock512 ? 512 : 256;
  // bf16 tile: a thread's depthwise work item is one 16-byte channel
  // group (8 channels) of R neighbouring output pixels of one row (a run)
  static constexpr int R = 4, CG = C / 8;
  static constexpr int RUNS_W = TW / R;
  static constexpr int IH = TH + 2 * PAD, IW = TW + 2 * PAD;
  static constexpr int V = 16 / sizeof(S);   // tile elements per 16 bytes
  static constexpr int VIO = 16 / sizeof(T); // I/O elements per 16 bytes
  // input tile: unpadded and swizzled at C >= 64 on the bf16 path, else
  // pixel rows padded by 8 elements (16 bytes in bf16, 32 in f32); either
  // way the warp's accesses below are free of shared-memory bank conflicts
  static constexpr bool kSwizzle = kMma && C % 64 == 0;
  static constexpr int LDX = kSwizzle ? C : C + 8;
  static constexpr int LDT = C + 8;          // bf16 t / output tile rows
  static constexpr size_t XBUF = sizeof(S) * IH * IW * LDX;
  // shared-memory layout (bytes)
  // depthwise weights: f32 [K*K][C]; for the bf16 tile [K*K][2][CG][4],
  // channel c at [c % 8 / 4][c / 8][c % 4], so that a warp's 16-byte reads
  // of one half of every group's 8 weights are contiguous
  static constexpr size_t OFF_DW = 0;
  static constexpr size_t OFF_LN = align16(OFF_DW + 4 * K * K * C);
  static constexpr size_t OFF_GN = align16(OFF_LN + 4 * C);
  static constexpr size_t OFF_X = align16(OFF_GN + 4 * C);
  // W2 and W3 stream through a ring of chunks of ECH of the E channels
  // (W2's rows, W3's columns; chunk_ring.cuh) where they do not fit beside
  // a tile: in bf16 where the padded rows would take more than half of a
  // block's shared memory (from C = 96: 155,136 B; C = 128: 272,384 B), in
  // f32 where they do not fit beside one tile (from C = 80, and (64, 7):
  // 131,072 B beside a 88,704 B tile)
  static constexpr size_t F32_RESIDENT_W = 2 * align16(4 * E * C);
  static constexpr size_t BF16_RESIDENT_W =
      align16(2 * E * (C + 8)) + align16(2 * C * (E + 8));
  static constexpr bool kStream =
      kMma ? BF16_RESIDENT_W > kMaxSmem / 2
           : OFF_X + XBUF + F32_RESIDENT_W > kMaxSmem;
  // a streamed chunk of ech E channels: bf16 W2 [ech][C + 8] and W3
  // [C][ech + 8] rows, f32 both in fragment order
  static constexpr size_t chunk_bytes(int ech) {
    return kMma ? align16(2 * ech * (C + 8)) + align16(2 * C * (ech + 8))
                : 2 * align16(4 * ech * C);
  }
  static constexpr size_t T_BYTES = kMma ? 2 * P * LDT : 0;
  // int8 I/O prefetches a tile's raw codes into a staging buffer
  // ([IH*IW][C]; in a ragged layout the tile's rows as they lie in device
  // memory, ROW_STAGE bytes a row: see load_rows_async)
  static constexpr size_t ROW_STAGE = align16(IW * C * sizeof(T) + 15);
  static constexpr size_t STAGE_BYTES =
      !kInt8 ? 0 : kRagged ? IH * ROW_STAGE : IH * IW * C;
  // whether three stages of chunks of ech E channels fit beside one tile
  // (and int8's staged codes) and t
  static constexpr bool three_fit(int ech) {
    return OFF_X + XBUF + STAGE_BYTES + T_BYTES + 3 * chunk_bytes(ech) +
               kRingBars <=
           kMaxSmem;
  }
  // chunks of 32 E channels where three fit, else of 16 (int8 (128, 7),
  // f32 (128, 5)); f32 where three of 16 do not fit either ((128, 7): a
  // 167,552 B tile) the ring takes the tile buffer's room, chunks of 32
  // from the first after the depthwise to the last, and the next tile is
  // copied once the products are done (kRingInX)
  static constexpr bool kRingInX = kStream && !kMma && !three_fit(16);
  static constexpr int ECH =
      kStream && !kRingInX && !three_fit(32) ? 16 : 32;
  static constexpr int NCH = E / ECH;
  // E channels per step of the products: their expansion accumulators are
  // EC/2 registers, and at C = 48 (two blocks an SM at K < 7) and C = 64
  // (512 threads) a thread has 128 in all (EC = 64 spilled at (48, 1));
  // from C = 96 a step is one streamed chunk
  static constexpr int EC = kStream ? ECH : C >= 48 ? 32 : 64;
  // f32: E channels per step of the products: their expansion accumulators
  // are EF/2 registers, and at C <= 32 (two blocks per SM) a thread has
  // 128; streamed, a step is one chunk
  static constexpr int EF = kStream ? ECH : C <= 32 ? 16 : 32;
  static_assert(!kStream || ((kMma ? EC : EF) == ECH && E % ECH == 0),
                "a step of the products is one streamed chunk");
  // E channels of W2 and W3 held in one weight buffer: all, or one chunk
  static constexpr int EW = kStream ? ECH : E;
  static constexpr int LDW2 = C + 8;         // bf16 W2 [EW][C] rows
  static constexpr int LDW3 = EW + 8;        // bf16 W3 [C][EW] rows
  // bf16/int8: W2 bf16 [EW][LDW2], then W3 bf16 [C][LDW3]
  // f32:       W2 and W3 f32 in fragment order, EW*C each (resident: the
  //            staging in the kernel; streamed: kernel_operands' chunks)
  static constexpr size_t W2_BYTES =
      align16(kMma ? 2 * EW * LDW2 : 4 * EW * C);
  static constexpr size_t W3_BYTES =
      align16(kMma ? 2 * C * LDW3 : 4 * EW * C);
  static constexpr size_t WBUF = W2_BYTES + W3_BYTES;
  static_assert(!kStream || WBUF == chunk_bytes(ECH), "one chunk a stage");
  // (32, 7) of its own runs two blocks an SM, as the layouts at K < 7 with
  // resident weights do: bf16 with one tile buffer (88,512 B; int8
  // 105,536 B); two tile buffers (131,072 B) held one block of 8 warps,
  // and two unpadded ones swizzled so that two blocks fit (114,048 B)
  // measured 2% slower (their offsets are added at run time)
  static constexpr bool kTwoBlocks7 = kMma && !kRagged && C == 32 && K == 7;
  // tile buffers: int8 I/O prefetches into its staging buffer, bf16 and
  // f32 I/O into a second tile where two fit beside the weights (streamed:
  // beside three stages); with one, bf16 refills it once every warp's
  // epilogue is done, f32 once every depthwise is (kRingInX: once the
  // products are)
  static constexpr int NXBUF =
      kInt8 || kRingInX || kTwoBlocks7 ? 1
      : OFF_X + 2 * XBUF + (kStream ? 3 : 1) * WBUF + T_BYTES +
                  (kStream ? kRingBars : 0) <=
              kMaxSmem
          ? 2
          : 1;
  static constexpr size_t OFF_STAGE = align16(OFF_X + NXBUF * XBUF);
  // the weight buffer or the ring's stages, then the bf16 t/out tile
  // [P][LDT] (int8 output rows are staged in the same rows), then the
  // ring's mbarriers
  static constexpr size_t OFF_W2 =
      kRingInX ? OFF_X : align16(OFF_STAGE + STAGE_BYTES);
  static constexpr size_t OFF_W3 = OFF_W2 + W2_BYTES;
  static constexpr size_t ring_fit(size_t room) {
    return room / WBUF < (size_t)kRingStages ? room / WBUF
                                             : (size_t)kRingStages;
  }
  // f32 streamed at C = 128: t (each lane's 64 values) waits in the tile
  // buffer's room while the products run (kRingInX: after the ring's
  // stages), so that the products hold only their accumulators in
  // registers (t there too spilled 12-40 bytes at 255); the one tile buffer
  // is then refilled once the epilogue is done
  static constexpr bool kParkT = !kMma && kStream && C == 128;
  static constexpr size_t TV_BYTES = kParkT ? 4 * NT * (C / 2) : 0;
  static constexpr int NS =
      !kStream  ? 1
      : kRingInX ? (int)ring_fit(XBUF - TV_BYTES)
                 : (int)ring_fit(kMaxSmem - OFF_W2 - T_BYTES - kRingBars);
  static constexpr size_t OFF_TV = kRingInX ? OFF_X + NS * WBUF : OFF_X;
  static_assert(OFF_TV + TV_BYTES <= OFF_X + XBUF, "t fits a tile's room");
  static_assert(!kStream || NS >= 3, "a ring of three stages or more");
  static constexpr int NCL = kStream ? kRingCluster : 1;
  static constexpr size_t OFF_T =
      kRingInX ? align16(OFF_X + XBUF) : OFF_W2 + NS * WBUF;
  static constexpr size_t OFF_BAR = OFF_T + T_BYTES;
  static constexpr size_t SMEM = OFF_BAR + (kStream ? kRingBars : 0);
  static_assert(XBUF % 16 == 0, "tile buffers keep 16-byte alignment");
  static_assert(SMEM <= kMaxSmem, "one block's shared memory fits");
  // the blocks per SM the registers are capped for: two wherever two fit
  // in the SM's shared memory at K < 7 with W2 and W3 resident (C <= 32,
  // and bf16 and int8 at C = 48) and at (32, 7) of its own; the other
  // K = 7 tiles leave room for one, and a streamed layout's products keep
  // C / 16 * 4 + C / 2 registers of A fragments and accumulators a lane
  static constexpr int MIN_BLOCKS =
      (K < 7 || kTwoBlocks7) && !kStream &&
              2 * (SMEM + kSmemPerBlock) <= kSmemPerSm
          ? 2
          : 1;
  static_assert(!kTwoBlocks7 || MIN_BLOCKS == 2, "(32, 7): two blocks");
  // bf16 of its own with one tile buffer ((32, 7), (64, 7), (128, 7)): a
  // warp's residual x moves into its own t rows once its A fragments are
  // loaded, so that the next tile is copied into the buffer under the
  // products and the epilogue (residual_to_t)
  static constexpr bool kResT = kMma && !kInt8 && !kRagged && NXBUF == 1;
  // the bf16 tile's depthwise at K = 7 of its own ((32, 7), (64, 7),
  // (128, 7)): by runs of two rows (depthwise_layernorm_rows2)
  static constexpr bool kRows2 = kMma && !kRagged && K == 7;

  // element offset, within a tile row, of 16-byte chunk `chunk` of the
  // pixel in column `ix`
  static __device__ __forceinline__ int xoff(int ix, int chunk) {
    if constexpr (kSwizzle) chunk ^= ix & 7;
    return ix * LDX + chunk * V;
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float leaky(float v, float slope) {
  return v >= 0.f ? v : v * slope;
}

// round(v * inv) half to even, clamped to the symmetric int8 range
__device__ __forceinline__ signed char quant_int8(float v, float inv) {
  const int q = __float2int_rn(__fmul_rn(v, inv));
  return (signed char)max(-127, min(127, q));
}

// D += A B for one m16n8k16 tile: A row-major bf16 (4 regs), B col-major
// bf16 (2 regs), D f32 (4 regs)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the
// shared-memory addresses of the 16-byte rows of matrix i, and lane l
// receives elements 2(l%4), 2(l%4)+1 of row l/4 of matrix i in r[i], which is
// how mma.sync lays out its A (row-major) and B (column-major) fragments.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(row)
      : "memory");
}

// Two 8x8 bf16 matrices: lanes 8i..8i+7 (i = 0, 1) give the rows of matrix
// i (the other lanes' addresses are not read)
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(row)
               : "memory");
}

// 16 bytes global -> shared (a shared-memory address), asynchronously: the
// first `bytes` (0 to 16) read from src, zeros after them (src must be a
// valid address all the same)
__device__ __forceinline__ void cp_async_16n(uint32_t dst, const void* src,
                                             int bytes) {
  const size_t s = __cvta_generic_to_global(src);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(s), "r"(bytes)
               : "memory");
}

// 16 bytes global -> shared; 16 zero bytes when !valid
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  cp_async_16n(dst, src, valid ? 16 : 0);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The bytes a copy of a ragged row moves: the largest power of two up to 16
// that divides a pixel's row of c channels of I/O type T
template <typename T>
__device__ __forceinline__ int io_unit(int c) {
  const int row = c * (int)sizeof(T);
  return min(16, row & -row);
}

// `unit` bytes global -> shared at dst (its shared-memory address sdst),
// zeros when !valid: cp.async of 16, 8 or 4 bytes, else a plain load and
// store (src must be a valid address all the same)
__device__ __forceinline__ void copy_unit(unsigned char* dst, uint32_t sdst,
                                          const unsigned char* src,
                                          bool valid, int unit) {
  const int bytes = valid ? unit : 0;
  const size_t s = __cvta_generic_to_global(src);
  if (unit == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sdst),
                 "l"(s), "r"(bytes)
                 : "memory");
  } else if (unit == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(sdst),
                 "l"(s), "r"(bytes)
                 : "memory");
  } else if (unit == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sdst),
                 "l"(s), "r"(bytes)
                 : "memory");
  } else if (unit == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        valid ? *reinterpret_cast<const uint16_t*>(src) : (uint16_t)0;
  } else {
    *dst = valid ? *src : (unsigned char)0;
  }
}

// `unit` bytes shared -> global
__device__ __forceinline__ void store_unit(unsigned char* dst,
                                           const unsigned char* src,
                                           int unit) {
  if (unit == 16)
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  else if (unit == 8)
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  else if (unit == 4)
    *reinterpret_cast<uint32_t*>(dst) =
        *reinterpret_cast<const uint32_t*>(src);
  else if (unit == 2)
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
  else
    *dst = *src;
}

// a tile's image and the image coordinates of its first output pixel
struct Tile {
  long long b;
  int y0, x0;
};

// Start the copies of one input tile plus halo into `dst`: the tile buffer
// (float and bf16 I/O) or the staging buffer of raw codes (int8 I/O). A
// ragged class copies the cr channels of each pixel in units of `unit`
// bytes and zeros the rest of the tile's C.
template <typename G, typename T>
__device__ __forceinline__ void load_tile_async(const T* __restrict__ x,
                                                unsigned char* dst, Tile t,
                                                int H, int W, int tid, int cr,
                                                int unit) {
  if constexpr (G::kRagged) {
    // copies per tile pixel (a power of two) and, of them, inside C. bf16
    // and int8 from C = 128 find a copy's pixel by a shift; the layouts at
    // their register cap (C <= 64: two blocks an SM or 512 threads; float32)
    // divide, since the shift's operands spill there
    const int upp = G::C * (int)sizeof(T) / unit, ush = __ffs(upp) - 1;
    const int valid = cr * (int)sizeof(T) / unit;
    const uint32_t d0 = shared_address(dst);
    const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
    for (int i = tid; i < G::IH * G::IW * upp; i += G::NT) {
      const int pix = G::kMma && G::C >= 128 ? i >> ush : i / upp;
      const int j = i - pix * upp;
      const int iy = pix / G::IW, ix = pix - iy * G::IW;
      const int gy = t.y0 - G::PAD + iy, gx = t.x0 - G::PAD + ix;
      const bool inside =
          j < valid && (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W;
      const int byte = j * unit;  // within the pixel's row
      const long long src =
          inside ? ((t.b * H + gy) * W + gx) * cr * (long long)sizeof(T) + byte
                 : 0;
      // the float tiles hold T itself: 16-byte chunk byte / 16 of the row
      const int d = G::kInt8 ? pix * G::C + byte
                             : (int)sizeof(T) * (iy * G::IW * G::LDX +
                                                 G::xoff(ix, byte / 16)) +
                                   byte % 16;
      copy_unit(dst + d, d0 + d, xb + src, inside, unit);
    }
    cp_async_commit();
    return;
  }
  // a row of the tile, halo included, is contiguous in x: ROW 16-byte chunks
  constexpr int CV = G::C / G::VIO, ROW = G::IW * CV;
  const uint32_t d0 = shared_address(dst);
  // element offset of the tile's first halo pixel (it may lie off the image)
  const long long origin =
      ((t.b * H + (t.y0 - G::PAD)) * W + (t.x0 - G::PAD)) * G::C;
  for (int i = tid; i < G::IH * ROW; i += G::NT) {
    const int iy = i / ROW, j = i - iy * ROW;
    const int ix = j / CV, cv = j % CV;
    const bool inside = (unsigned)(t.y0 - G::PAD + iy) < (unsigned)H &&
                        (unsigned)(t.x0 - G::PAD + ix) < (unsigned)W;
    // a copy of no bytes still takes a valid address: the tensor's start
    const T* src =
        inside ? x + (origin + ((iy * W + ix) * G::C + cv * G::VIO)) : x;
    const int d = G::kInt8 ? (iy * G::IW + ix) * G::C + cv * 16
                           : (int)sizeof(typename G::S) *
                                 (iy * G::IW * G::LDX + G::xoff(ix, cv));
    cp_async_16(d0 + d, src, inside);
  }
  cp_async_commit();
}

// int8 I/O: staged codes -> bf16 tile, bf16(q * bf16(scale_in))
template <typename G>
__device__ __forceinline__ void dequantize_tile(
    const unsigned char* __restrict__ stage, bf16* __restrict__ xs,
    float s_in, int tid) {
  constexpr int CV = G::C / 16;
  for (int i = tid; i < G::IH * G::IW * CV; i += G::NT) {
    const int cv = i % CV, pix = i / CV;
    const int iy = pix / G::IW, ix = pix % G::IW;
    const uint4 v =
        *reinterpret_cast<const uint4*>(stage + pix * G::C + cv * 16);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
    bf16* row = xs + iy * G::IW * G::LDX;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 d;
      uint32_t* dp = reinterpret_cast<uint32_t*>(&d);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // (float)q without the slow I2F: code + 128 as the low byte of
        // 2^23's mantissa is exactly 2^23 + 128 + q
        const uint32_t u = words[2 * h + j] ^ 0x80808080u;
        float f[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + e)) -
                 8388736.f;
        dp[2 * j] = pack_bf16(__fmul_rn(f[0], s_in), __fmul_rn(f[1], s_in));
        dp[2 * j + 1] =
            pack_bf16(__fmul_rn(f[2], s_in), __fmul_rn(f[3], s_in));
      }
      *reinterpret_cast<uint4*>(row + G::xoff(ix, 2 * cv + h)) = d;
    }
  }
}

// ---- the ragged layouts' copies (kRagged: a true C, cr, from C - 15 to C)

// How a launch moves a ragged tile, from cr. Each function that moves a
// tile sets it up from an opaque cr (a value the compiler may not hoist out
// of the tile loop): the few integer operations a tile are cheaper than
// the registers the fields would hold across the kernel, at the register
// caps of two blocks an SM and of the float32 layouts
struct RaggedIO {
  int row_bytes;  // a pixel's row in device memory: cr * sizeof(T)
  int unit;       // the largest power of two up to 16 that divides it
  int per_px;     // units a pixel's row
  int p0, j0;     // this thread's first (pixel, unit) of a tile's copies
  int dp, dj;     // NT copies further on, in (pixel, unit)
  int row_stage;  // int8: bytes a tile row takes staged,
                  // align16(IW * row + 15) (load_rows_async)
};

__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

template <typename G, typename T>
__device__ __forceinline__ RaggedIO ragged_io(int cr, int tid) {
  RaggedIO io;
  cr = opaque(cr);
  io.row_bytes = cr * (int)sizeof(T);
  io.unit = min(16, io.row_bytes & -io.row_bytes);
  io.per_px = io.row_bytes >> (__ffs(io.unit) - 1);
  io.p0 = tid / io.per_px;
  io.j0 = tid - io.p0 * io.per_px;
  io.dp = G::NT / io.per_px;
  io.dj = G::NT - io.dp * io.per_px;
  io.row_stage = (G::IW * io.row_bytes + 30) & ~15;  // align16(n + 15)
  return io;
}

// Start the copies of a ragged tile plus halo into the tile buffer `dst`
// (bf16 and f32), pixel by pixel: the cr channels of each pixel in units
// of io.unit bytes (cp.async of 16, 8 or 4 bytes, else plain loads), zeros
// outside the image. The tile's channels past cr are never written: they
// stay the zeros the kernel clears the buffers to. A thread walks its
// (pixel, unit) pairs by io's steps, so the loop divides by no variable.
template <typename G, typename T>
__device__ __forceinline__ void load_tile_units(const T* __restrict__ x,
                                                unsigned char* dst, Tile t,
                                                int H, int W, int tid,
                                                int cr) {
  static_assert(!G::kInt8, "int8 stages its rows");
  const RaggedIO io = ragged_io<G, T>(cr, tid);
  const uint32_t d0 = shared_address(dst);
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  int pix = io.p0, j = io.j0;
  for (int i = tid; i < G::IH * G::IW * io.per_px; i += G::NT) {
    const int iy = pix / G::IW, ix = pix - iy * G::IW;
    const int gy = t.y0 - G::PAD + iy, gx = t.x0 - G::PAD + ix;
    const bool inside = (unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W;
    const int byte = j * io.unit;  // within the pixel's row
    const long long src =
        inside ? ((t.b * H + gy) * W + gx) * io.row_bytes + byte : 0;
    const int d = (int)sizeof(T) * (iy * G::IW * G::LDX + G::xoff(ix, byte >> 4)) +
                  (byte & 15);
    copy_unit(dst + d, d0 + d, xb + src, inside, io.unit);
    pix += io.dp;
    j += io.dj;
    if (j >= io.per_px) j -= io.per_px, ++pix;
  }
  cp_async_commit();
}

// Start the copies of a ragged int8 tile's rows into the stage `dst` as they
// lie in device memory: a tile row's pixels inside the image are one
// contiguous run there, copied by 16-byte cp.async from the 16-byte
// boundary at or before its first byte (row iy of the stage at
// iy * io.row_stage, the run's first byte at its offset from that
// boundary). The last copy of a run reads only up to the run's end and
// zero-fills the rest, so no copy reads past the tensor. Rows outside the
// image are not copied.
template <typename G, typename T>
__device__ __forceinline__ void load_rows_async(const T* __restrict__ x,
                                                unsigned char* dst, Tile t,
                                                int H, int W, int tid,
                                                int cr) {
  static_assert(G::kInt8, "int8 stages its rows");
  constexpr int MAXCH = (int)(G::ROW_STAGE / 16);  // at cr = C
  const RaggedIO io = ragged_io<G, T>(cr, tid);
  const int gx_lo = max(0, t.x0 - G::PAD);
  const int gx_hi = min(W, t.x0 - G::PAD + G::IW);
  const long long run = (long long)(gx_hi - gx_lo) * io.row_bytes;
  const uint32_t d0 = shared_address(dst);
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  for (int i = tid; i < G::IH * MAXCH; i += G::NT) {
    const int iy = i / MAXCH, k = i - iy * MAXCH;
    const int gy = t.y0 - G::PAD + iy;
    if ((unsigned)gy >= (unsigned)H) continue;
    const long long s = ((t.b * H + gy) * W + gx_lo) * io.row_bytes;
    const long long chunk = (s & ~15LL) + 16 * k, left = s + run - chunk;
    if (left > 0)
      cp_async_16n(d0 + iy * io.row_stage + 16 * k, xb + chunk,
                   (int)min(16LL, left));
  }
  cp_async_commit();
}

// N bytes from shared memory at p, whose address is a multiple of al (1,
// 2, 4, 8 or 16), into words
template <int N>
__device__ __forceinline__ void load_bytes(const unsigned char* p, int al,
                                           uint32_t (&w)[N / 4]) {
  if constexpr (N == 16) {
    if (al >= 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
      return;
    }
  }
  if (al >= 8) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint2 u = *reinterpret_cast<const uint2*>(p + 8 * i);
      w[2 * i] = u.x, w[2 * i + 1] = u.y;
    }
  } else if (al == 4) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      w[i] = *reinterpret_cast<const uint32_t*>(p + 4 * i);
  } else if (al == 2) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      w[i] = (uint32_t)*reinterpret_cast<const uint16_t*>(p + 4 * i) |
             (uint32_t)*reinterpret_cast<const uint16_t*>(p + 4 * i + 2) << 16;
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      w[i] = (uint32_t)p[4 * i] | (uint32_t)p[4 * i + 1] << 8 |
             (uint32_t)p[4 * i + 2] << 16 | (uint32_t)p[4 * i + 3] << 24;
  }
}

// int8 codes (two words) -> 8 bf16, bf16(q * bf16(scale_in)) (as
// dequantize_tile)
__device__ __forceinline__ uint4 dequantize8(const uint32_t (&w)[2],
                                             float s_in) {
  uint4 d;
  uint32_t* dp = reinterpret_cast<uint32_t*>(&d);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const uint32_t u = w[j] ^ 0x80808080u;
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + e)) -
             8388736.f;
    dp[2 * j] = pack_bf16(__fmul_rn(f[0], s_in), __fmul_rn(f[1], s_in));
    dp[2 * j + 1] = pack_bf16(__fmul_rn(f[2], s_in), __fmul_rn(f[3], s_in));
  }
  return d;
}

// The staged int8 rows (load_rows_async) -> the bf16 tile: each (pixel, 8
// channels) of the tile read from its place in the stage and dequantized,
// channels past cr and pixels outside the image zero. A pixel's row starts
// at a multiple of io.unit in the stage, which sets the loads' width.
template <typename G, typename T>
__device__ __forceinline__ void relayout_tile(
    const unsigned char* __restrict__ stage, bf16* __restrict__ xs, Tile t,
    int H, int W, int tid, int cr, float s_in) {
  static_assert(G::kInt8, "int8 stages its rows");
  constexpr int CG = G::C / 8;
  const RaggedIO io = ragged_io<G, T>(cr, tid);
  const int gx_lo = max(0, t.x0 - G::PAD);
  for (int i = tid; i < G::IH * G::IW * CG; i += G::NT) {
    const int pix = i / CG, cg = i - pix * CG;
    const int iy = pix / G::IW, ix = pix - iy * G::IW;
    const int gy = t.y0 - G::PAD + iy, gx = t.x0 - G::PAD + ix;
    const int nvalid = cr - 8 * cg;  // channels of the group inside cr
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if ((unsigned)gy < (unsigned)H && (unsigned)gx < (unsigned)W &&
        nvalid > 0) {
      // the row's run starts (s & 15) bytes into its stage row
      const unsigned head =
          (unsigned)((t.b * H + gy) * W + gx_lo) * (unsigned)io.row_bytes & 15u;
      const unsigned char* p = stage + iy * io.row_stage + head +
                               (gx - gx_lo) * io.row_bytes + cg * 8;
      uint32_t w[2];
      load_bytes<8>(p, io.unit, w);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e >= nvalid) w[e >> 2] &= ~(0xffu << (8 * (e & 3)));
      v = dequantize8(w, s_in);
    }
    *reinterpret_cast<uint4*>(xs + iy * G::IW * G::LDX + G::xoff(ix, cg)) = v;
  }
}

// The sum of v over the N lanes of a segment (a run's lanes: pos = lane -
// base, base its first lane), in every lane of it: a butterfly where N
// divides 32, else a tree towards the segment's first lane (each add only
// from inside the segment) and its broadcast. Every lane of the warp calls
// it; lanes past the last whole segment form a short one of their own.
template <int N>
__device__ __forceinline__ float segment_sum(float v, int pos, int base) {
  if constexpr ((N & (N - 1)) == 0) {
#pragma unroll
    for (int o = 1; o < N; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
  } else {
#pragma unroll
    for (int o = 1; o < N; o <<= 1) {
      const float u = __shfl_down_sync(0xffffffffu, v, o);
      if (pos + o < N) v += u;
    }
    return __shfl_sync(0xffffffffu, v, base);
  }
}

// Depthwise KxK + LayerNorm on the bf16 tile, t -> ts as bf16 rows. Per tap
// row the thread loads its K x 8 weights and the R + K - 1 input vectors
// once each and does the R*K*8 FMAs from registers, taps in (dy, dx) order
// per output. The CG = C/8 threads that share a run of R pixels are
// neighbouring lanes of one warp, 32 / CG runs a warp round (where CG does
// not divide 32 the last 32 % CG lanes idle: they compute on a valid run
// and store nothing): the LayerNorm's mean and its centred variance (two
// passes, f32) are sums over the run's lanes (segment_sum). Every lane of
// a warp takes part in each round, and pixels outside the image are
// computed on the tile's zeros, so the shuffles always see a full warp.
template <typename G>
__device__ __forceinline__ void depthwise_layernorm(
    const bf16* __restrict__ xs, const float* __restrict__ dws,
    const float* __restrict__ lns, bf16* __restrict__ ts, int tid, int cr,
    float inv_cr) {
  constexpr int C = G::C, K = G::K, R = G::R, CG = G::CG;
  constexpr int RUNS = G::TH * G::RUNS_W, RPW = 32 / CG;
  constexpr int WROUNDS = (RUNS + RPW - 1) / RPW;
  static_assert(G::TW % R == 0 && CG <= 32, "runs tile the rows");
  // a ragged class takes the statistics over the true C (inv_cr = 1 / cr)
  const float inv_c = G::kRagged ? inv_cr : 1.f / C;
  const int lane = tid & 31, lane_run = lane / CG;
  const int cg = lane - lane_run * CG, base = lane_run * CG;
  for (int wr = tid >> 5; wr < WROUNDS; wr += G::NT / 32) {
    const int raw = wr * RPW + lane_run;
    // where CG divides 32 and RUNS is whole rounds, every lane is active
    constexpr bool kFull = 32 % CG == 0 && RUNS % RPW == 0;
    const bool active = kFull || (lane_run < RPW && raw < RUNS);
    const int run = kFull || raw < RUNS ? raw : RUNS - 1;
    const int ry = run / G::RUNS_W, rx = (run % G::RUNS_W) * R;
    int xo[R + K - 1];  // this thread's chunk of each input pixel of a row
#pragma unroll
    for (int i = 0; i < R + K - 1; ++i) xo[i] = G::xoff(rx + i, cg);
    const float4* wp = reinterpret_cast<const float4*>(dws) + cg;
    float acc[R][8];
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[j][c] = 0.f;
    if constexpr (K >= 7) {
      // (the class widths; the layouts of their own take
      // depthwise_layernorm_rows2) a row's K x 8 weights would hold 56
      // registers beside the 32 accumulators: each tap's 8 weights in
      // turn, its R inputs loaded for it (the same FMAs in the same order
      // per output; the compiler loads and converts each input once a row
      // across the unrolled taps), and the rows not unrolled into each
      // other
#pragma unroll 1
      for (int dy = 0; dy < K; ++dy) {
        const bf16* xrow = xs + (ry + dy) * G::IW * G::LDX;
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float4 lo = wp[((dy * K + dx) * 2 + 0) * CG];
          const float4 hi = wp[((dy * K + dx) * 2 + 1) * CG];
          const float w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const uint4 raw = *reinterpret_cast<const uint4*>(xrow + xo[j + dx]);
            const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int h = 0; h < 4; ++h) {  // bf16 -> f32 is exact
              acc[j][2 * h] = fmaf(__uint_as_float(u[h] << 16), w[2 * h],
                                   acc[j][2 * h]);
              acc[j][2 * h + 1] = fmaf(__uint_as_float(u[h] & 0xffff0000u),
                                       w[2 * h + 1], acc[j][2 * h + 1]);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const bf16* xrow = xs + (ry + dy) * G::IW * G::LDX;
        float w[K][8];
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const float4 lo = wp[((dy * K + dx) * 2 + 0) * CG];
          const float4 hi = wp[((dy * K + dx) * 2 + 1) * CG];
          w[dx][0] = lo.x, w[dx][1] = lo.y, w[dx][2] = lo.z, w[dx][3] = lo.w;
          w[dx][4] = hi.x, w[dx][5] = hi.y, w[dx][6] = hi.z, w[dx][7] = hi.w;
        }
#pragma unroll
        for (int i = 0; i < R + K - 1; ++i) {
          const uint4 raw = *reinterpret_cast<const uint4*>(xrow + xo[i]);
          const uint32_t u[4] = {raw.x, raw.y, raw.z, raw.w};
          float xv[8];
#pragma unroll
          for (int h = 0; h < 4; ++h) {  // bf16 -> f32 is exact
            xv[2 * h] = __uint_as_float(u[h] << 16);
            xv[2 * h + 1] = __uint_as_float(u[h] & 0xffff0000u);
          }
#pragma unroll
          for (int dx = 0; dx < K; ++dx) {
            const int j = i - dx;  // the output pixel this tap feeds
            if (j >= 0 && j < R) {
#pragma unroll
              for (int c = 0; c < 8; ++c)
                acc[j][c] = fmaf(xv[c], w[dx][c], acc[j][c]);
            }
          }
        }
      }
    }
    const float4 l0 = reinterpret_cast<const float4*>(lns)[2 * cg];
    const float4 l1 = reinterpret_cast<const float4*>(lns)[2 * cg + 1];
    const float lw[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float* a = acc[j];
      const float sum = segment_sum<CG>(((a[0] + a[1]) + (a[2] + a[3])) +
                                            ((a[4] + a[5]) + (a[6] + a[7])),
                                        cg, base);
      // (a ragged class: the padded channels' sums are 0, and their
      // centred values are masked)
      const float mean = sum * inv_c;
      float sq = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        a[c] = !G::kRagged || cg * 8 + c < cr ? a[c] - mean : 0.f;
        sq = fmaf(a[c], a[c], sq);
      }
      sq = segment_sum<CG>(sq, cg, base);
      const float rs = rsqrtf(sq * inv_c + kLnEps);
      uint4 v;
      v.x = pack_bf16(a[0] * rs * lw[0], a[1] * rs * lw[1]);
      v.y = pack_bf16(a[2] * rs * lw[2], a[3] * rs * lw[3]);
      v.z = pack_bf16(a[4] * rs * lw[4], a[5] * rs * lw[5]);
      v.w = pack_bf16(a[6] * rs * lw[6], a[7] * rs * lw[7]);
      if (active)
        *reinterpret_cast<uint4*>(ts + (ry * G::TW + rx + j) * G::LDT +
                                  cg * 8) = v;
    }
  }
}

// Depthwise KxK + LayerNorm on the bf16 tile at K = 7 of the layouts of
// their own (kRows2: (32, 7), (64, 7), (128, 7)), t -> ts as bf16 rows. A
// thread owns 4 channels (a half of a 16-byte group: lane q of the C / 4
// lanes of a run, channels 4q .. 4q + 3) of R = 4 neighbouring pixels in
// each of two neighbouring rows (2 ry, 2 ry + 1). It walks the K + 1 input
// rows those need once: per input row it loads the 8-byte halves of its
// R + K - 1 input vectors and converts each once, and each feeds both
// output rows (the first at tap row dy = iy, the second at dy = iy - 1),
// whose K x 4 weights (28 registers each) are loaded once per input row
// and passed on from the first output row to the second. So an input
// element is loaded and converted once per two output rows, a weight once
// per two; taps in (dy, dx) order per output, as depthwise_layernorm. The
// C / 4 lanes of a run are neighbours (a whole warp at C = 128): the
// LayerNorm's mean and centred variance are butterfly sums over them.
// The 8-byte loads of a half-warp cover one or two whole pixel rows (at
// C = 32 two pixels 4 apart, whose 80-byte rows fall in opposite halves of
// the bank line): free of bank conflicts.
template <typename G>
__device__ __forceinline__ void depthwise_layernorm_rows2(
    const bf16* __restrict__ xs, const float* __restrict__ dws,
    const float* __restrict__ lns, bf16* __restrict__ ts, int tid) {
  constexpr int C = G::C, K = G::K, R = G::R, CG = G::CG, Q = C / 4;
  constexpr int RUNS_W = G::TW / R, RUNS = G::TH / 2 * RUNS_W, RPW = 32 / Q;
  static_assert(32 % Q == 0 && RUNS % RPW == 0 && G::TH % 2 == 0,
                "runs of two rows tile the tile, whole runs a warp");
  const int lane = tid & 31, q = lane % Q;
  // this lane's 4 weights of a tap (float4 (tap 2 + q % 2) CG + q / 2)
  const float4* wq = reinterpret_cast<const float4*>(dws) + (q & 1) * CG +
                     (q >> 1);
  const float4 lw = reinterpret_cast<const float4*>(lns)[q];
  for (int wr = tid >> 5; wr < RUNS / RPW; wr += G::NT / 32) {
    const int run = wr * RPW + lane / Q;
    const int ry = run / RUNS_W * 2, rx = run % RUNS_W * R;
    int xo[R + K - 1];  // this lane's half of each input pixel of a row
#pragma unroll
    for (int i = 0; i < R + K - 1; ++i) xo[i] = G::xoff(rx + i, q >> 1) + 4 * (q & 1);
    float a0[R][4], a1[R][4];
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) a0[j][c] = a1[j][c] = 0.f;
    float4 wc[K], wp[K];  // tap rows iy (first output row), iy - 1 (second)
#pragma unroll
    for (int iy = 0; iy <= K; ++iy) {
      const bf16* xrow = xs + (ry + iy) * G::IW * G::LDX;
#pragma unroll
      for (int dx = 0; dx < K; ++dx) {
        wp[dx] = wc[dx];
        if (iy < K) wc[dx] = wq[(iy * K + dx) * 2 * CG];
      }
#pragma unroll
      for (int i = 0; i < R + K - 1; ++i) {
        const uint2 raw = *reinterpret_cast<const uint2*>(xrow + xo[i]);
        // bf16 -> f32 is exact
        const float xv[4] = {__uint_as_float(raw.x << 16),
                             __uint_as_float(raw.x & 0xffff0000u),
                             __uint_as_float(raw.y << 16),
                             __uint_as_float(raw.y & 0xffff0000u)};
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const int j = i - dx;  // the output pixel this tap feeds
          if (j >= 0 && j < R) {
            if (iy < K) {
              a0[j][0] = fmaf(xv[0], wc[dx].x, a0[j][0]);
              a0[j][1] = fmaf(xv[1], wc[dx].y, a0[j][1]);
              a0[j][2] = fmaf(xv[2], wc[dx].z, a0[j][2]);
              a0[j][3] = fmaf(xv[3], wc[dx].w, a0[j][3]);
            }
            if (iy > 0) {
              a1[j][0] = fmaf(xv[0], wp[dx].x, a1[j][0]);
              a1[j][1] = fmaf(xv[1], wp[dx].y, a1[j][1]);
              a1[j][2] = fmaf(xv[2], wp[dx].z, a1[j][2]);
              a1[j][3] = fmaf(xv[3], wp[dx].w, a1[j][3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float* a = r == 0 ? a0[j] : a1[j];
        const float sum = segment_sum<Q>((a[0] + a[1]) + (a[2] + a[3]), 0, 0);
        const float mean = sum * (1.f / C);
        float sq = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          a[c] -= mean;
          sq = fmaf(a[c], a[c], sq);
        }
        sq = segment_sum<Q>(sq, 0, 0);
        const float rs = rsqrtf(sq * (1.f / C) + kLnEps);
        uint2 v;
        v.x = pack_bf16(a[0] * rs * lw.x, a[1] * rs * lw.y);
        v.y = pack_bf16(a[2] * rs * lw.z, a[3] * rs * lw.w);
        *reinterpret_cast<uint2*>(ts + ((ry + r) * G::TW + rx + j) * G::LDT +
                                  4 * q) = v;
      }
    }
  }
}

// One step of both 1x1 products on the tensor cores for one m16 tile of t
// rows (A fragments af): the expansion of EC of the E channels, whose
// accumulators, leaky-ReLU'd and rounded to bf16, are the projection's A
// fragments in registers, then that step's share of the projection into
// pacc. w2 / w3: this lane's ldmatrix row addresses at the step's first E
// row of W2 and first E column of W3.
template <typename G>
__device__ __forceinline__ void expand_project(
    const uint32_t (&af)[G::C / 16][4], float (&pacc)[G::C / 8][4],
    uint32_t w2, uint32_t w3, float slope) {
  constexpr int C = G::C;
  // a step of fewer than 32 E channels (streamed chunks of 16) sums each
  // n8 tile's k16 steps in KS chains of their own (step kt in chain
  // kt % KS), added in order at the end, so that four chains of dependent
  // products are in flight as with 32
  constexpr int KS = G::EC >= 32 ? 1 : 32 / G::EC;
  float hacc[G::EC / 8][4];
  float hpart[G::EC / 8][KS][4];
#pragma unroll
  for (int nt = 0; nt < G::EC / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < KS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) hpart[nt][j][i] = 0.f;
#pragma unroll
    for (int kt = 0; kt + 1 < C / 16; kt += 2) {
      uint32_t b[4];  // B fragments of two k16 steps
      ldmatrix_x4(b, w2 + 2 * (nt * 8 * G::LDW2 + kt * 16));
      mma_bf16(hpart[nt][kt % KS], af[kt], b[0], b[1]);
      mma_bf16(hpart[nt][(kt + 1) % KS], af[kt + 1], b[2], b[3]);
    }
    if constexpr (C / 16 % 2 == 1) {
      // the last k16 step of an odd number of them (C = 16, 48, 80, 112)
      uint32_t b[2];
      ldmatrix_x2(b, w2 + 2 * (nt * 8 * G::LDW2 + (C / 16 - 1) * 16));
      mma_bf16(hpart[nt][(C / 16 - 1) % KS], af[C / 16 - 1], b[0], b[1]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hacc[nt][i] = hpart[nt][0][i];
#pragma unroll
      for (int j = 1; j < KS; ++j) hacc[nt][i] += hpart[nt][j][i];
    }
  }
#pragma unroll
  for (int kk = 0; kk < G::EC / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(leaky(hacc[2 * kk][0], slope),
                     leaky(hacc[2 * kk][1], slope));
    a[1] = pack_bf16(leaky(hacc[2 * kk][2], slope),
                     leaky(hacc[2 * kk][3], slope));
    a[2] = pack_bf16(leaky(hacc[2 * kk + 1][0], slope),
                     leaky(hacc[2 * kk + 1][1], slope));
    a[3] = pack_bf16(leaky(hacc[2 * kk + 1][2], slope),
                     leaky(hacc[2 * kk + 1][3], slope));
#pragma unroll
    for (int nt = 0; nt < C / 8; nt += 2) {
      uint32_t b[4];  // B fragments of two n8 groups
      ldmatrix_x4(b, w3 + 2 * (nt * 8 * G::LDW3 + kk * 16));
      mma_bf16(pacc[nt], a, b[0], b[1]);
      mma_bf16(pacc[nt + 1], a, b[2], b[3]);
    }
  }
}

// A ragged layout's out = x + gain * p for the warp's m16 tile at pixel m0
// (16 neighbouring pixels of one tile row, one contiguous run of
// 16 * cr channels in device memory): the warp writes its pixels' cr
// channels (int8: requantized) into its own rows of the t tile packed as
// in device memory, the run's first byte at its offset from a 16-byte
// boundary, and stores the run in 16-byte units from that boundary on;
// the run's first and last unit, where it starts or ends inside one, in
// pieces of io.unit bytes that lie inside it.
template <typename G, typename T>
__device__ __forceinline__ void store_rows_ragged(
    const bf16* __restrict__ xs, bf16* __restrict__ ts,
    const float (&pacc)[G::C / 8][4], const float* __restrict__ gns,
    T* __restrict__ out, Tile t, int H, int W, float inv_out, int m0,
    int lane, int cr) {
  constexpr int C = G::C, ESZ = (int)sizeof(T);
  const RaggedIO io = ragged_io<G, T>(cr, lane);
  static_assert(16 * C * ESZ + 15 <= 16 * G::LDT * 2,
                "a run fits the warp's rows of the t tile");
  const int g = lane >> 2, q = lane & 3;
  const int ly = m0 / G::TW, lx0 = m0 % G::TW;
  const int gy = t.y0 + ly, gx0 = t.x0 + lx0;
  const long long s = ((t.b * H + gy) * W + gx0) * io.row_bytes;
  const int head = (int)(s & 15);
  unsigned char* pk = reinterpret_cast<unsigned char*>(ts + m0 * G::LDT);
  const bool even = (cr & 1) == 0;
  __syncwarp();  // every lane has its A fragments: the rows may change
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt) {
    const int c = nt * 8 + 2 * q;
    if (c < cr) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = g + 8 * hf;
        const bf16* xr = xs + (ly + G::PAD) * G::IW * G::LDX +
                         G::xoff(lx0 + r + G::PAD, nt) + 2 * q;
        const float o0 = __fadd_rn(bid::to_float(xr[0]),
                                   __fmul_rn(gns[c], pacc[nt][2 * hf]));
        const float o1 = __fadd_rn(bid::to_float(xr[1]),
                                   __fmul_rn(gns[c + 1],
                                             pacc[nt][2 * hf + 1]));
        unsigned char* d = pk + head + r * io.row_bytes + c * ESZ;
        if constexpr (G::kInt8) {
          const signed char q0 = quant_int8(o0, inv_out);
          const signed char q1 = quant_int8(o1, inv_out);
          if (even) {
            char2 qv;
            qv.x = q0, qv.y = q1;
            *reinterpret_cast<char2*>(d) = qv;
          } else {
            d[0] = (unsigned char)q0;
            if (c + 1 < cr) d[1] = (unsigned char)q1;
          }
        } else {
          const uint32_t v = pack_bf16(o0, o1);
          if (even) {
            *reinterpret_cast<uint32_t*>(d) = v;
          } else {
            *reinterpret_cast<uint16_t*>(d) = (uint16_t)v;
            if (c + 1 < cr) *reinterpret_cast<uint16_t*>(d + 2) = v >> 16;
          }
        }
      }
    }
  }
  __syncwarp();
  const int n = min(16, W - gx0);  // the run's pixels inside the image
  if (gy >= H || n <= 0) return;
  const long long e = s + (long long)n * io.row_bytes, first = s & ~15LL;
  const int nch = (int)((e - first + 15) >> 4);
  unsigned char* ob = reinterpret_cast<unsigned char*>(out);
  for (int k = lane; k < nch; k += 32) {
    const long long a = first + 16 * k;
    if (a >= s && a + 16 <= e) {
      *reinterpret_cast<uint4*>(ob + a) =
          *reinterpret_cast<const uint4*>(pk + 16 * k);
    } else {
      for (int b = 0; b < 16; b += io.unit)
        if (a + b >= s && a + b < e)
          store_unit(ob + a + b, pk + 16 * k + b, io.unit);
    }
  }
}

// out = x + gain * p for the warp's m16 tile at pixel m0 of the tile, from
// the projection's accumulators, into the warp's own rows of the t tile
// (int8: requantized, C bytes at the start of each row) and from there to
// device memory with 16-byte stores.
template <typename G, typename T>
__device__ __forceinline__ void store_tile_rows(
    const bf16* __restrict__ xs, bf16* __restrict__ ts,
    const float (&pacc)[G::C / 8][4], const float* __restrict__ gns,
    T* __restrict__ out, Tile t, int H, int W, float inv_out, int m0,
    int lane, int cr) {
  if constexpr (G::kRagged) {
    store_rows_ragged<G, T>(xs, ts, pacc, gns, out, t, H, W, inv_out, m0,
                            lane, cr);
    return;
  }
  constexpr int C = G::C;
  const int g = lane >> 2, q = lane & 3;
  __syncwarp();  // every lane has its A fragments: the rows may change
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt) {
    const int c = nt * 8 + 2 * q;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + g + 8 * hf;
      const int ly = m / G::TW, lx = m % G::TW;
      // (kResT: x waits in the warp's t rows, under the output)
      const bf16* xr = G::kResT ? ts + m * G::LDT + c
                                : xs + (ly + G::PAD) * G::IW * G::LDX +
                                      G::xoff(lx + G::PAD, nt) + 2 * q;
      const float o0 = __fadd_rn(bid::to_float(xr[0]),
                                 __fmul_rn(gns[c], pacc[nt][2 * hf]));
      const float o1 = __fadd_rn(bid::to_float(xr[1]),
                                 __fmul_rn(gns[c + 1], pacc[nt][2 * hf + 1]));
      if constexpr (G::kInt8) {
        char2 qv;
        qv.x = quant_int8(o0, inv_out);
        qv.y = quant_int8(o1, inv_out);
        *reinterpret_cast<char2*>(
            reinterpret_cast<signed char*>(ts + m * G::LDT) + c) = qv;
      } else {
        *reinterpret_cast<uint32_t*>(ts + m * G::LDT + c) = pack_bf16(o0, o1);
      }
    }
  }
  __syncwarp();
  constexpr int OV = C / G::VIO;  // 16-byte stores per pixel
  for (int i = lane; i < 16 * OV; i += 32) {
    const int m = m0 + i / OV, cv = i % OV;
    const int gy = t.y0 + m / G::TW, gx = t.x0 + m % G::TW;
    if (gy < H && gx < W)
      *reinterpret_cast<uint4*>(out + ((t.b * H + gy) * W + gx) * C +
                                cv * G::VIO) =
          *reinterpret_cast<const uint4*>(
              reinterpret_cast<const unsigned char*>(ts + m * G::LDT) +
              cv * 16);
  }
}

// kResT: the residual x of the warp's m16 tile at pixel m0 into its own
// rows of the t tile, once every lane has its A fragments from them; the
// epilogue reads x there and writes the output over it
template <typename G>
__device__ __forceinline__ void residual_to_t(const bf16* __restrict__ xs,
                                              bf16* __restrict__ ts, int m0,
                                              int lane) {
  constexpr int CV = G::C / 8;  // 16-byte chunks a pixel
  __syncwarp();
  for (int i = lane; i < 16 * CV; i += 32) {
    const int m = m0 + i / CV, cv = i % CV;
    const int ly = m / G::TW, lx = m % G::TW;
    *reinterpret_cast<uint4*>(ts + m * G::LDT + cv * 8) =
        *reinterpret_cast<const uint4*>(xs + (ly + G::PAD) * G::IW * G::LDX +
                                        G::xoff(lx + G::PAD, cv));
  }
  __syncwarp();
}

// this lane's ldmatrix row addresses (matrix lane / 8, row lane % 8):
// A of t rows: matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15) of a k16 step;
// B of W2 [EW][C]: one n8 group of rows, k 0-7 | 8-15 | 16-23 | 24-31;
// B of W3 [C][EW]: n8 groups (nt | nt + 1) x (k 0-7 | 8-15) of a k16 step
template <typename G>
struct LaneRows {
  uint32_t a, w2, w3;
  __device__ __forceinline__ LaneRows(const bf16* ts, const bf16* w2s,
                                      const bf16* w3s, int lane) {
    const int lr = lane & 7, lm = lane >> 3;
    a = shared_address(ts + (lr + (lm & 1) * 8) * G::LDT + (lm >> 1) * 8);
    w2 = shared_address(w2s + lr * G::LDW2 + lm * 8);
    w3 = shared_address(w3s + ((lm >> 1) * 8 + lr) * G::LDW3 + (lm & 1) * 8);
  }
};

// the A fragments of the m16 tile at pixel m0 of the t tile
template <typename G>
__device__ __forceinline__ void load_a(uint32_t (&af)[G::C / 16][4],
                                       uint32_t a_lane, int m0) {
#pragma unroll
  for (int kt = 0; kt < G::C / 16; ++kt)
    ldmatrix_x4(af[kt], a_lane + 2 * (m0 * G::LDT + kt * 16));
}

// Both 1x1 products on the tensor cores with W2 and W3 resident, 16 pixels
// (one m16 tile of t rows) per warp and step, then the epilogue.
template <typename G, typename T>
__device__ __forceinline__ void products_store(
    const bf16* __restrict__ xs, bf16* __restrict__ ts,
    const bf16* __restrict__ w2s, const bf16* __restrict__ w3s,
    const float* __restrict__ gns, T* __restrict__ out, Tile t, int H, int W,
    float slope, float inv_out, int tid, int cr) {
  const int warp = tid >> 5, lane = tid & 31;
  const LaneRows<G> rows(ts, w2s, w3s, lane);
  for (int mt = warp; mt < G::P / 16; mt += G::NT / 32) {
    const int m0 = mt * 16;
    uint32_t af[G::C / 16][4];
    load_a<G>(af, rows.a, m0);
    float pacc[G::C / 8][4];
#pragma unroll
    for (int nt = 0; nt < G::C / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) pacc[nt][i] = 0.f;
#pragma unroll 1
    for (int ec = 0; ec < G::E; ec += G::EC)
      expand_project<G>(af, pacc, rows.w2 + 2 * ec * G::LDW2,
                        rows.w3 + 2 * ec, slope);
    store_tile_rows<G, T>(xs, ts, pacc, gns, out, t, H, W, inv_out, m0, lane,
                          cr);
  }
}

// D += A B for one m16n8k8 tile on TF32 operands: A row-major (4 regs), B
// column-major (2 regs), D f32 (4 regs). The tensor core reads the top 19
// bits of each f32 operand. Not volatile, so that the compiler may
// interleave independent products
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v = big + small exactly: big is v truncated to TF32, small the rest (the
// weights: the compiler passes v itself for big, as the tensor core
// truncates it the same way)
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(v, __uint_as_float(big)));
}

// the same with big rounded to nearest, ties away from zero (t and h: a
// value of its own, which also spares the copies that would line a
// permuted A fragment up from the accumulators)
__device__ __forceinline__ void split_tf32_rn(float v, uint32_t& big,
                                              uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(v, __uint_as_float(big)));
}

// Two n8 tiles of a 3xTF32 product: d0, d1 += A B with A split into ab, as
// and the B fragments of both tiles in one 16-byte vector from shared
// memory (b0, b1 of tile 0, then of tile 1). Per tile small.big and
// big.small go before big.big; the two tiles' chains interleave.
__device__ __forceinline__ void mma_3xtf32_pair(float (&d0)[4], float (&d1)[4],
                                                const uint32_t (&ab)[4],
                                                const uint32_t (&as)[4],
                                                float4 b) {
  uint32_t bb[4], bs[4];
  split_tf32(b.x, bb[0], bs[0]);
  split_tf32(b.y, bb[1], bs[1]);
  split_tf32(b.z, bb[2], bs[2]);
  split_tf32(b.w, bb[3], bs[3]);
  mma_tf32(d0, as, bb[0], bb[1]);
  mma_tf32(d1, as, bb[2], bb[3]);
  mma_tf32(d0, ab, bs[0], bs[1]);
  mma_tf32(d1, ab, bs[2], bs[3]);
  mma_tf32(d0, ab, bb[0], bb[1]);
  mma_tf32(d1, ab, bb[2], bb[3]);
}

// One n8 tile of a 3xTF32 product over two k-steps: d += A0 B0 + A1 B1
// with A0 split into ab0, as0 and A1 into ab1, as1, and the B fragments of
// both k-steps in one 16-byte vector from shared memory (b0, b1 of k-step
// 0, then of k-step 1). small.big and big.small go before big.big.
__device__ __forceinline__ void mma_3xtf32_ksteps(
    float (&d)[4], const uint32_t (&ab0)[4], const uint32_t (&as0)[4],
    const uint32_t (&ab1)[4], const uint32_t (&as1)[4], float4 b) {
  uint32_t bb[4], bs[4];
  split_tf32(b.x, bb[0], bs[0]);
  split_tf32(b.y, bb[1], bs[1]);
  split_tf32(b.z, bb[2], bs[2]);
  split_tf32(b.w, bb[3], bs[3]);
  mma_tf32(d, as0, bb[0], bb[1]);
  mma_tf32(d, ab0, bs[0], bs[1]);
  mma_tf32(d, as1, bb[2], bb[3]);
  mma_tf32(d, ab1, bs[2], bs[3]);
  mma_tf32(d, ab0, bb[0], bb[1]);
  mma_tf32(d, ab1, bb[2], bb[3]);
}

// split four f32 values into the A fragment (big, small) of an m16n8k8 tile
__device__ __forceinline__ void split_a(float a0, float a1, float a2,
                                        float a3, uint32_t (&ab)[4],
                                        uint32_t (&as)[4]) {
  split_tf32_rn(a0, ab[0], as[0]);
  split_tf32_rn(a1, ab[1], as[1]);
  split_tf32_rn(a2, ab[2], as[2]);
  split_tf32_rn(a3, ab[3], as[3]);
}

// f32 I/O with streamed weights (C = 128, 96, 80, (64, 7)): one E chunk of both
// products for the warp's 16 pixels in 3xTF32, 16 E channels (two n8 tiles of
// the expansion, one k-step pair of the projection) a step, the steps not
// unrolled into each other. tv(p, i) gives the lane's t[p][4i .. 4i + 3] (pixel
// 2g + p, channels 16i + 4q .. + 3), from registers or, at C = 128, from shared
// memory (kParkT). The chunk's W2 and W3 arrive in fragment order
// (kernel_operands arranges them; one 16-byte vector per lane g = lane / 4, q =
// lane % 4, with pair(n, j) = 16 (n / 2) + 4 (j / 2) + 2 (n % 2) + j % 2): W2
// vector (n, i) holds channels 16i + 4q .. + 3 of the chunk's E row pair(n, g),
// the B operands of the expansion's k-steps 2i, 2i + 1 for its n8 tile n; W3
// vector (m, o) holds the chunk's E 16m + 4q .. + 3 of output channel pair(o,
// g), the B operands of the projection's k-steps 2m, 2m + 1 for its n8 tile o.
// The expansion's n8 tile n holds E channels pair(n, 2q), + 1 of the chunk in
// its accumulators d0, d1 (row g) and d2, d3 (row g + 8); as d0, d2, d1, d3
// those of tiles 2m and 2m + 1 are the A fragments of the projection's k-steps
// 2m and 2m + 1, whose E channels 16m + 4q .. + 3 are the lane's W3 vector. The
// projection's n8 tile o holds output channels pair(o, 2q), + 1: tiles 2i and
// 2i + 1 are channels 16i + 4q .. + 3.
template <typename G, typename TV>
__device__ __forceinline__ void expand_project_f32(
    TV tv, float (&pacc)[G::C / 8][4], const float4* __restrict__ w2c,
    const float4* __restrict__ w3c, float slope, int lane) {
  constexpr int C = G::C, ECH = G::ECH;
#pragma unroll 1
  for (int m = 0; m < ECH / 16; ++m) {
    float hacc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) hacc[n][r] = 0.f;
    // expansion: k-steps 2i and 2i + 1 are channels 16i + 4q + {0, 1} and
    // + {2, 3} of rows g (pixel 2g) and g + 8 (pixel 2g + 1)
#pragma unroll
    for (int i = 0; i < C / 16; ++i) {
      const float4 t0 = tv(0, i), t1 = tv(1, i);
      uint32_t ab0[4], as0[4], ab1[4], as1[4];
      split_a(t0.x, t1.x, t0.y, t1.y, ab0, as0);
      split_a(t0.z, t1.z, t0.w, t1.w, ab1, as1);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        mma_3xtf32_ksteps(hacc[n], ab0, as0, ab1, as1,
                          w2c[((2 * m + n) * (C / 16) + i) * 32 + lane]);
    }
    uint32_t ab0[4], as0[4], ab1[4], as1[4];
    split_a(leaky(hacc[0][0], slope), leaky(hacc[0][2], slope),
            leaky(hacc[0][1], slope), leaky(hacc[0][3], slope), ab0, as0);
    split_a(leaky(hacc[1][0], slope), leaky(hacc[1][2], slope),
            leaky(hacc[1][1], slope), leaky(hacc[1][3], slope), ab1, as1);
#pragma unroll
    for (int o = 0; o < C / 8; ++o)
      mma_3xtf32_ksteps(pacc[o], ab0, as0, ab1, as1,
                        w3c[(m * (C / 8) + o) * 32 + lane]);
  }
}

// f32 I/O, depthwise KxK + LayerNorm of the warp's tile row ry: lane (g, q)
// owns pixels 2g and 2g + 1 and channels 16i + 4q .. + 3 of each group i.
// Per group and tap row it loads the K weight vectors and the K + 1 input
// vectors once and does the 2K x 4 FMAs from registers, taps in (dy, dx)
// order per output. The 4 lanes of a pixel pair are neighbours: mean and
// centred variance (two passes, f32) are butterfly sums over them. Pixels
// outside the image are computed on the tile's zeros, so every lane takes
// part. t and the pixels' own x (the centre tap) are left in registers,
// [pixel][4i + r].
template <typename G>
__device__ __forceinline__ void depthwise_layernorm_f32(
    const float* __restrict__ xs, const float* __restrict__ dws,
    const float* __restrict__ lns, float (&tv)[2][G::C / 4],
    float (&xc)[2][G::C / 4], int ry, int lane, int cr, float inv_cr) {
  constexpr int C = G::C, K = G::K, PAD = G::PAD;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < C / 16; ++i) {
    const int c = 16 * i + 4 * q;
    float4 acc[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                     make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll
    for (int dy = 0; dy < K; ++dy) {
      const float* xrow = xs + ((ry + dy) * G::IW + 2 * g) * G::LDX + c;
      float4 w[K];
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
        w[dx] = *reinterpret_cast<const float4*>(dws + (dy * K + dx) * C + c);
#pragma unroll
      for (int j = 0; j < K + 1; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(xrow + j * G::LDX);
        if (dy == PAD && j >= PAD && j < PAD + 2) {
          float* xp = xc[j - PAD] + 4 * i;
          xp[0] = v.x, xp[1] = v.y, xp[2] = v.z, xp[3] = v.w;
        }
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          const int p = j - dx;  // the output pixel this tap feeds
          if (p >= 0 && p < 2) {
            acc[p].x = fmaf(v.x, w[dx].x, acc[p].x);
            acc[p].y = fmaf(v.y, w[dx].y, acc[p].y);
            acc[p].z = fmaf(v.z, w[dx].z, acc[p].z);
            acc[p].w = fmaf(v.w, w[dx].w, acc[p].w);
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float* tp = tv[p] + 4 * i;
      tp[0] = acc[p].x, tp[1] = acc[p].y, tp[2] = acc[p].z, tp[3] = acc[p].w;
    }
  }
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float* a = tv[p];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < C / 16; ++i)
      sum += (a[4 * i] + a[4 * i + 1]) + (a[4 * i + 2] + a[4 * i + 3]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    // a ragged class: over the true C, the padded channels masked
    const float inv_c = G::kRagged ? inv_cr : 1.f / C;
    const float mean = sum * inv_c;
    float sq = 0.f;
#pragma unroll
    for (int r = 0; r < C / 4; ++r) {
      a[r] = !G::kRagged || 16 * (r / 4) + 4 * q + r % 4 < cr ? a[r] - mean
                                                               : 0.f;
      sq = fmaf(a[r], a[r], sq);
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    const float rs = rsqrtf(sq * inv_c + kLnEps);
#pragma unroll
    for (int i = 0; i < C / 16; ++i) {
      const float4 l =
          *reinterpret_cast<const float4*>(lns + 16 * i + 4 * q);
      a[4 * i] = a[4 * i] * rs * l.x;
      a[4 * i + 1] = a[4 * i + 1] * rs * l.y;
      a[4 * i + 2] = a[4 * i + 2] * rs * l.z;
      a[4 * i + 3] = a[4 * i + 3] * rs * l.w;
    }
  }
}

// f32 I/O: out = x + gain * p of the warp's 16 pixels (tile row ry) from
// the projection's accumulators: n8 tiles 2i and 2i + 1 hold channels
// 16i + 4q + {0, 1} and + {2, 3} of rows g (accumulators 0, 1; pixel 2g)
// and g + 8 (2, 3; pixel 2g + 1). x is the lane's registers xc, or at
// C = 128 read back from device memory.
template <typename G>
__device__ __forceinline__ void store_row_f32(
    const float (&pacc)[G::C / 8][4], const float (&xc)[2][G::C / 4],
    const float* __restrict__ x, const float* __restrict__ gns,
    float* __restrict__ out, Tile t, int ry, int H, int W, int lane, int cr) {
  constexpr int C = G::C;
  const int g = lane >> 2, q = lane & 3;
  const int gy = t.y0 + ry;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int gx = t.x0 + 2 * g + p;
    if constexpr (G::kRagged) {
      // the true cr channels: 16 bytes at a time where a pixel's row is
      // whole 16-byte vectors (cr % 4 == 0) and the weights are resident,
      // else one float at a time (streamed, the registers are at their cap)
      if (!G::kStream && gy < H && gx < W && (cr & 3) == 0) {
        const long long base = ((t.b * H + gy) * W + gx) * cr;
#pragma unroll
        for (int i = 0; i < C / 16; ++i) {
          const int c = 16 * i + 4 * q;
          if (c < cr) {
            const float4 gn = *reinterpret_cast<const float4*>(gns + c);
            float4 xv;
            if constexpr (G::kStream) {
              xv = __ldg(reinterpret_cast<const float4*>(x + base + c));
            } else {
              const float* v = xc[p] + 4 * i;
              xv = make_float4(v[0], v[1], v[2], v[3]);
            }
            float4 o;
            o.x = __fadd_rn(xv.x, __fmul_rn(gn.x, pacc[2 * i][2 * p]));
            o.y = __fadd_rn(xv.y, __fmul_rn(gn.y, pacc[2 * i][2 * p + 1]));
            o.z = __fadd_rn(xv.z, __fmul_rn(gn.z, pacc[2 * i + 1][2 * p]));
            o.w = __fadd_rn(xv.w,
                            __fmul_rn(gn.w, pacc[2 * i + 1][2 * p + 1]));
            *reinterpret_cast<float4*>(out + base + c) = o;
          }
        }
      } else if (gy < H && gx < W) {
        const long long base = ((t.b * H + gy) * W + gx) * cr;
#pragma unroll
        for (int i = 0; i < C / 16; ++i) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int c = 16 * i + 4 * q + r;
            if (c < cr) {
              const float xv =
                  G::kStream ? __ldg(x + base + c) : xc[p][4 * i + r];
              out[base + c] = __fadd_rn(
                  xv, __fmul_rn(gns[c], pacc[2 * i + r / 2][2 * p + r % 2]));
            }
          }
        }
      }
      continue;
    }
    if (gy < H && gx < W) {
      const long long base = ((t.b * H + gy) * W + gx) * C;
#pragma unroll
      for (int i = 0; i < C / 16; ++i) {
        const int c = 16 * i + 4 * q;
        const float4 gn = *reinterpret_cast<const float4*>(gns + c);
        float4 xv;
        if constexpr (G::kStream) {
          xv = __ldg(reinterpret_cast<const float4*>(x + base + c));
        } else {
          const float* v = xc[p] + 4 * i;
          xv = make_float4(v[0], v[1], v[2], v[3]);
        }
        float4 o;
        o.x = __fadd_rn(xv.x, __fmul_rn(gn.x, pacc[2 * i][2 * p]));
        o.y = __fadd_rn(xv.y, __fmul_rn(gn.y, pacc[2 * i][2 * p + 1]));
        o.z = __fadd_rn(xv.z, __fmul_rn(gn.z, pacc[2 * i + 1][2 * p]));
        o.w = __fadd_rn(xv.w, __fmul_rn(gn.w, pacc[2 * i + 1][2 * p + 1]));
        *reinterpret_cast<float4*>(out + base + c) = o;
      }
    }
  }
}

// f32 I/O: both 1x1 products of the warp's 16 pixels in 3xTF32 from t in
// registers, EF of the E channels a step, then out = x + gain * p stored
// from the projection's accumulators. w2f and w3f are W2 and W3 in
// fragment order (the kernel's staging): 32 lanes' 16-byte vectors per
// (k-step, pair of n8 tiles).
template <typename G>
__device__ __forceinline__ void products_store_f32(
    const float (&tv)[2][G::C / 4], const float (&xc)[2][G::C / 4],
    const float4* __restrict__ w2f, const float4* __restrict__ w3f,
    const float* __restrict__ gns, float* __restrict__ out, Tile t, int ry,
    int H, int W, float slope, int lane, int cr) {
  constexpr int C = G::C, E = G::E, EF = G::EF;
  float pacc[C / 8][4];
#pragma unroll
  for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) pacc[nt][r] = 0.f;
#pragma unroll 1
  for (int ec = 0; ec < E; ec += EF) {
    float hacc[EF / 8][4];
#pragma unroll
    for (int nt = 0; nt < EF / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) hacc[nt][r] = 0.f;
    // expansion: k-step j covers channels 16(j/2) + 4q + 2(j%2) + {0, 1}
    // of rows g (pixel 2g) and g + 8 (pixel 2g + 1)
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int r = 4 * (j >> 1) + 2 * (j & 1);
      uint32_t ab[4], as[4];
      split_tf32_rn(tv[0][r], ab[0], as[0]);
      split_tf32_rn(tv[1][r], ab[1], as[1]);
      split_tf32_rn(tv[0][r + 1], ab[2], as[2]);
      split_tf32_rn(tv[1][r + 1], ab[3], as[3]);
#pragma unroll
      for (int np = 0; np < EF / 16; ++np)
        mma_3xtf32_pair(hacc[2 * np], hacc[2 * np + 1], ab, as,
                        w2f[(j * (E / 16) + ec / 16 + np) * 32 + lane]);
    }
    // projection: the expansion's accumulators of n8 tile n, as d0, d2,
    // d1, d3, are the A fragment of k-step ec / 8 + n
#pragma unroll
    for (int n = 0; n < EF / 8; ++n) {
      uint32_t ab[4], as[4];
      split_tf32_rn(leaky(hacc[n][0], slope), ab[0], as[0]);
      split_tf32_rn(leaky(hacc[n][2], slope), ab[1], as[1]);
      split_tf32_rn(leaky(hacc[n][1], slope), ab[2], as[2]);
      split_tf32_rn(leaky(hacc[n][3], slope), ab[3], as[3]);
#pragma unroll
      for (int i = 0; i < C / 16; ++i)
        mma_3xtf32_pair(pacc[2 * i], pacc[2 * i + 1], ab, as,
                        w3f[((ec / 8 + n) * (C / 16) + i) * 32 + lane]);
    }
  }
  store_row_f32<G>(pacc, xc, nullptr, gns, out, t, ry, H, W, lane, cr);
}

// A persistent block's tiles: a cluster of NCL blocks (NCL = 1: a block)
// takes NCL neighbouring tiles a round, cluster cid of n the rounds cid,
// cid + n, ... of the ceil(ntiles / NCL); block r of it tile NCL round + r.
// In the last round a block of a cluster may find no tile (a tile count
// that NCL does not divide, or one image smaller than the cluster): it
// runs a ghost tile whose rows lie past the image, computed on zeros and
// stored nowhere, so that it takes every chunk of the ring with the
// cluster's other blocks. The tile grid and the cluster's place are worked
// out from the launch's shape, blockIdx and gridDim where they are needed,
// not held in registers.
template <typename G>
struct TileWalk {
  int rounds;
  __device__ __forceinline__ TileWalk(int B, int H, int W) {
    // the grid is no larger than the rounds' clusters
    rounds = ((ntiles(B, H, W) + G::NCL - 1) / G::NCL - 1 -
              (int)blockIdx.x / G::NCL) /
                 ((int)gridDim.x / G::NCL) +
             1;
  }
  static __device__ __forceinline__ int tiles_w(int W) {
    return (W + G::TW - 1) / G::TW;
  }
  static __device__ __forceinline__ int tiles_h(int H) {
    return (H + G::TH - 1) / G::TH;
  }
  // the launcher checks the range
  static __device__ __forceinline__ int ntiles(int B, int H, int W) {
    return B * tiles_h(H) * tiles_w(W);
  }
  __device__ __forceinline__ Tile at(int round, int B, int H, int W) const {
    const int i = ((int)blockIdx.x / G::NCL +
                   round * ((int)gridDim.x / G::NCL)) * G::NCL +
                  (int)blockIdx.x % G::NCL;
    if constexpr (G::NCL > 1) {
      if (i >= ntiles(B, H, W)) return Tile{0, H, 0};
    }
    const int rest = i / tiles_w(W);
    return Tile{rest / tiles_h(H), rest % tiles_h(H) * G::TH,
                i % tiles_w(W) * G::TW};
  }
};

// The ring of a streamed layout G (chunk_ring.cuh) over the chunks the
// kernel's w2 points to (kernel_operands' images: chunk c at c WBUF bytes,
// its W2 rows then its W3 columns, as its stage holds them; w3 is the same
// tensor). A block's chunks are counted over its tiles: chunk c of round
// r is g = r NCH + c, so the ring holds no state of its own in registers
// (the float32 layouts run at their register cap); its addresses are
// rebuilt from smem where they are used.
template <typename G>
struct StreamedWeights {
  using Ring = bid_ring::ChunkRing<G::NS, G::NCL, (uint32_t)G::WBUF>;
  static __device__ __forceinline__ Ring ring(unsigned char* smem) {
    return Ring(smem + G::OFF_BAR, smem + G::OFF_W2);
  }
  // thread 0, before any use; then the cluster meets (sync_cluster)
  static __device__ __forceinline__ void init(unsigned char* smem, int tid) {
    if (tid == 0) ring(smem).init(G::NT / 32);
  }
  // one thread: chunk j of the running count (waiting for its stage)
  static __device__ __forceinline__ void issue(unsigned char* smem, int j,
                                               const void* chunks) {
    ring(smem).issue(j, static_cast<const unsigned char*>(chunks) +
                            (size_t)(j % G::NCH) * G::WBUF);
  }
  // thread 0: round r's chunks up to NS - 1 ahead of its first, below
  // limit
  static __device__ __forceinline__ void prime(unsigned char* smem, int r,
                                               int limit, int tid,
                                               const void* chunks) {
    if (tid == 0)
      for (int j = r * G::NCH; j < r * G::NCH + G::NS - 1 && j < limit; ++j)
        issue(smem, j, chunks);
  }
  // round r's NCH chunks: wait for each, use(shared-memory byte offset of
  // its stage from stage 0, the chunk's parity), release it, and (thread
  // 0) issue the chunk NS - 1 ahead of it, below limit
  template <typename F>
  static __device__ __forceinline__ void walk(unsigned char* smem, int r,
                                              int limit, int tid,
                                              const void* chunks, F use) {
    const int lane = tid & 31;
    const Ring ring_ = ring(smem);
#pragma unroll 1
    for (int c = 0; c < G::NCH; ++c) {
      const int g = r * G::NCH + c;
      ring_.wait(g);
      use((uint32_t)(g % G::NS) * (uint32_t)G::WBUF, g & 1);
      ring_.release(g, lane);
      if (tid == 0 && g + G::NS - 1 < limit)
        issue(smem, g + G::NS - 1, chunks);
    }
  }
};

// cr: the true channels (a ragged class; C at the (C, K) of their own),
// inv_cr its reciprocal
template <typename T, int C, int K, bool RG>
__global__ void __launch_bounds__(Cfg<T, C, K, RG>::NT,
                                  Cfg<T, C, K, RG>::MIN_BLOCKS)
convnext_block_kernel(const T* __restrict__ x, T* __restrict__ out,
                      const float* __restrict__ dw,
                      const float* __restrict__ ln,
                      const typename Cfg<T, C, K, RG>::S* __restrict__ w2,
                      const typename Cfg<T, C, K, RG>::S* __restrict__ w3,
                      const float* __restrict__ gain, int B, int H, int W,
                      int cr, float inv_cr, float slope, float s_in,
                      float inv_out) {
  using G = Cfg<T, C, K, RG>;
  using S = typename G::S;
  constexpr int E = G::E, NT = G::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* dws = reinterpret_cast<float*>(smem + G::OFF_DW);
  float* lns = reinterpret_cast<float*>(smem + G::OFF_LN);
  float* gns = reinterpret_cast<float*>(smem + G::OFF_GN);
  S* w2s = reinterpret_cast<S*>(smem + G::OFF_W2);
  S* w3s = reinterpret_cast<S*>(smem + G::OFF_W3);
  const int tid = threadIdx.x;

  const TileWalk<G> walk(B, H, W);
  // where the copies of the next tile land: the staging buffer (int8), the
  // other tile buffer (bf16, f32 but at (64, 5)) or the only one
  int buf = 0;
  auto landing = [&](int b) {
    return smem + (G::kInt8 ? G::OFF_STAGE : G::OFF_X + b * G::XBUF);
  };
  auto start_copies = [&](unsigned char* dst, Tile tt) {
    if constexpr (!G::kRagged) {
      load_tile_async<G>(x, dst, tt, H, W, tid, G::C, 16);
    } else if constexpr (G::kInt8) {
      load_rows_async<G>(x, dst, tt, H, W, tid, cr);
    } else if constexpr (!G::kMma && G::kStream) {
      // float32 with streamed weights copies at its register cap (t and the
      // accumulators hold 112 - 128 registers across the chunks, the copies
      // of the next tile start at chunk 0): the per-pixel units of
      // load_tile_async, which divides, as every f32 class did, where the
      // walk's operands spill
      load_tile_async<G>(x, dst, tt, H, W, tid, cr, io_unit<T>(cr));
    } else {
      load_tile_units<G>(x, dst, tt, H, W, tid, cr);
    }
  };
  if constexpr (G::kRagged) {
    // the per-pixel copies write a tile's cr channels only: the rest stays
    // zero from here on
    for (int i = tid; i < G::NXBUF * (int)(G::XBUF / 16); i += NT)
      reinterpret_cast<uint4*>(smem + G::OFF_X)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
  }
  // the streamed layouts' ring: its barriers ready in every block of the
  // cluster before any block's copies or releases reach them
  using SW = StreamedWeights<G>;
  if constexpr (G::kStream) {
    SW::init(smem, tid);
    bid_ring::sync_cluster<G::NCL>();
  }
  start_copies(landing(buf), walk.at(0, B, H, W));
  // the chunks run on from tile to tile (kRingInX: each tile's from its
  // depthwise on); the first NS - 1 follow the first tile's input
  if constexpr (G::kStream && !G::kRingInX)
    SW::prime(smem, 0, walk.rounds * G::NCH, tid, w2);

  // ---- weights, once per block, while the first tile is on its way
  for (int i = tid; i < C * K * K; i += NT) {
    const int c = i / (K * K), tap = i % (K * K);
    if constexpr (G::kMma)
      dws[((tap * 2 + c % 8 / 4) * G::CG + c / 8) * 4 + c % 4] = dw[i];
    else
      dws[tap * C + c] = dw[i];
  }
  for (int c = tid; c < C; c += NT) {
    lns[c] = ln[c];
    gns[c] = gain[c];
  }
  if constexpr (G::kStream) {
    // W2 and W3 stream through the ring with each tile's products
  } else if constexpr (G::kMma) {
    for (int i = tid; i < E * C / 8; i += NT) {
      const int e = i / (C / 8), c8 = i % (C / 8);
      *reinterpret_cast<uint4*>(w2s + e * G::LDW2 + c8 * 8) =
          *reinterpret_cast<const uint4*>(w2 + e * C + c8 * 8);
    }
    for (int i = tid; i < C * E / 8; i += NT) {
      const int c = i / (E / 8), e8 = i % (E / 8);
      *reinterpret_cast<uint4*>(w3s + c * G::LDW3 + e8 * 8) =
          *reinterpret_cast<const uint4*>(w3 + c * E + e8 * 8);
    }
  } else {
    // f32: W2 and W3 in fragment order, one 16-byte vector per lane of a
    // (k-step, pair of n8 tiles): b0, b1 of tile 0, then of tile 1. B of the
    // expansion (k: channels of t, n: E rows): k-step j of lane (g, q)
    // holds channels 16(j/2) + 4q + 2(j%2) + {0, 1}, and n8 tile 2np + s is
    // E rows 16np + 8s + g. B of the projection (k: E, n: output channels):
    // k-step ks holds E channels 8ks + 2q + {0, 1} (the order
    // [0,2,4,6,1,3,5,7] of the expansion's accumulators), and n8 tile
    // 2np + s is output channel 16np + 4(g/2) + 2s + g%2. Scalar loads: the
    // weights need no 16-byte alignment
    float4* w2f = reinterpret_cast<float4*>(w2s);
    float4* w3f = reinterpret_cast<float4*>(w3s);
#pragma unroll 4
    for (int i = tid; i < E * C / 4; i += NT) {
      const int lane = i & 31, g = lane >> 2, q = lane & 3, rest = i >> 5;
      const int j = rest / (E / 16), np2 = rest % (E / 16);
      const float* r2 =
          w2 + (16 * np2 + g) * C + 16 * (j >> 1) + 4 * q + 2 * (j & 1);
      w2f[i] = make_float4(r2[0], r2[1], r2[8 * C], r2[8 * C + 1]);
      const int ks = rest / (C / 16), np3 = rest % (C / 16);
      const float* r3 =
          w3 + (16 * np3 + 4 * (g >> 1) + (g & 1)) * E + 8 * ks + 2 * q;
      w3f[i] = make_float4(r3[0], r3[1], r3[2 * E], r3[2 * E + 1]);
    }
  }

  const int warp = tid >> 5, lane = tid & 31;
  for (int round = 0; round < walk.rounds; ++round) {
    const Tile t = walk.at(round, B, H, W);
    const bool more = round + 1 < walk.rounds;
    S* xs = reinterpret_cast<S*>(smem + G::OFF_X + buf * G::XBUF);
    cp_async_wait_all();
    // this tile (or its codes) has landed and the weights are staged; every
    // warp is done with the previous tile's buffers
    __syncthreads();
    if constexpr (G::kInt8) {
      if constexpr (G::kRagged)
        relayout_tile<G, T>(smem + G::OFF_STAGE, xs, t, H, W, tid, cr, s_in);
      else
        dequantize_tile<G>(smem + G::OFF_STAGE, xs, s_in, tid);
      __syncthreads();
    }
    if constexpr (G::kMma) {
      // the next tile goes to the other buffer (bf16 I/O) or, as codes, to
      // the staging buffer that the pass above has just emptied (int8 I/O);
      // bf16 with one tile buffer refills it once every warp's residual x
      // has left it: into t (kResT: the layouts of their own) or read by
      // the epilogue (the class widths from 80 at K = 7)
      constexpr bool kRefillLate = !G::kInt8 && G::NXBUF == 1 && !G::kResT;
      if constexpr (!kRefillLate && !G::kResT) {
        buf ^= G::NXBUF - 1;
        if (more) start_copies(landing(buf), walk.at(round + 1, B, H, W));
      }
      bf16* ts = reinterpret_cast<bf16*>(smem + G::OFF_T);
      if constexpr (G::kRows2)
        depthwise_layernorm_rows2<G>(xs, dws, lns, ts, tid);
      else
        depthwise_layernorm<G>(xs, dws, lns, ts, tid, cr, inv_cr);
      __syncthreads();
      if constexpr (G::kStream) {
        // one m16 tile a warp, its A fragments and the projection's
        // accumulators (64 a lane) in registers across the chunks
        static_assert(G::P / 16 == NT / 32, "one m16 tile a warp");
        const LaneRows<G> rows(ts, w2s, w3s, lane);
        uint32_t af[C / 16][4];
        load_a<G>(af, rows.a, 16 * warp);
        if constexpr (G::kResT) {
          residual_to_t<G>(xs, ts, 16 * warp, lane);
          __syncthreads();  // every warp's x is out of the tile buffer
          if (more) start_copies(landing(0), walk.at(round + 1, B, H, W));
        }
        float pacc[C / 8][4];
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) pacc[nt][i] = 0.f;
        SW::walk(smem, round, walk.rounds * G::NCH, tid, w2,
                 [&](uint32_t b, int) {
          expand_project<G>(af, pacc, rows.w2 + b, rows.w3 + b, slope);
        });
        store_tile_rows<G, T>(xs, ts, pacc, gns, out, t, H, W, inv_out,
                              16 * warp, lane, cr);
      } else if constexpr (G::kResT) {
        // the warp's MT m16 tiles: all their A fragments first, then their
        // x into their t rows
        constexpr int MT = G::P / 16 / (NT / 32);
        const LaneRows<G> rows(ts, w2s, w3s, lane);
        uint32_t af[MT][C / 16][4];
#pragma unroll
        for (int u = 0; u < MT; ++u)
          load_a<G>(af[u], rows.a, 16 * (warp + u * (NT / 32)));
#pragma unroll
        for (int u = 0; u < MT; ++u)
          residual_to_t<G>(xs, ts, 16 * (warp + u * (NT / 32)), lane);
        __syncthreads();  // every warp's x is out of the tile buffer
        if (more) start_copies(landing(0), walk.at(round + 1, B, H, W));
#pragma unroll
        for (int u = 0; u < MT; ++u) {
          float pacc[C / 8][4];
#pragma unroll
          for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) pacc[nt][i] = 0.f;
#pragma unroll 1
          for (int ec = 0; ec < E; ec += G::EC)
            expand_project<G>(af[u], pacc, rows.w2 + 2 * ec * G::LDW2,
                              rows.w3 + 2 * ec, slope);
          store_tile_rows<G, T>(xs, ts, pacc, gns, out, t, H, W, inv_out,
                                16 * (warp + u * (NT / 32)), lane, cr);
        }
      } else {
        products_store<G>(xs, ts, w2s, w3s, gns, out, t, H, W, slope,
                          inv_out, tid, cr);
      }
      if constexpr (kRefillLate) {
        if (more) {
          __syncthreads();  // every warp is done with this tile's x
          start_copies(landing(0), walk.at(round + 1, B, H, W));
        }
      }
    } else {
      // f32: the next tile goes to the other buffer where there are two,
      // else into this one once every warp has done its depthwise (the
      // products need only registers and the weights; kParkT: once the
      // epilogue is done)
      if constexpr (G::NXBUF == 2) {
        buf ^= 1;
        if (more) start_copies(landing(buf), walk.at(round + 1, B, H, W));
      }
      float tv[2][C / 4], xc[2][C / 4];
      depthwise_layernorm_f32<G>(xs, dws, lns, tv, xc, warp, lane, cr,
                                 inv_cr);
      if constexpr (G::kStream) {
        // t waits in this tile's room (kParkT) once every depthwise is done
        // with the tile: vector p C/16 + i of a thread, NT threads apart,
        // holds its t[p][4i .. 4i + 3]; else the one tile buffer takes
        // the next tile now
        float4* tq = reinterpret_cast<float4*>(
                         G::kRingInX ? smem + G::OFF_TV
                                     : reinterpret_cast<unsigned char*>(xs)) +
                     tid;
        if constexpr (G::kParkT) {
          __syncthreads();
#pragma unroll
          for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int i = 0; i < C / 16; ++i)
              tq[(p * (C / 16) + i) * NT] =
                  make_float4(tv[p][4 * i], tv[p][4 * i + 1],
                              tv[p][4 * i + 2], tv[p][4 * i + 3]);
        } else if constexpr (G::NXBUF == 1) {
          __syncthreads();
          if (more) start_copies(landing(buf), walk.at(round + 1, B, H, W));
        }
        if constexpr (G::kRingInX) {
          // every block of the cluster is past its tile buffer: the ring
          // takes its room for this tile's chunks
          bid_ring::sync_cluster<G::NCL>();
          SW::prime(smem, round, (round + 1) * G::NCH, tid, w2);
        }
        // x is read back from device memory for the residual (x stays out
        // of the registers)
        float pacc[C / 8][4];
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) pacc[nt][i] = 0.f;
        const unsigned char* ring = smem + G::OFF_W2;
        auto t_at = [&](int p, int i) {
          if constexpr (G::kParkT)
            return tq[(p * (C / 16) + i) * NT];
          else
            return make_float4(tv[p][4 * i], tv[p][4 * i + 1],
                               tv[p][4 * i + 2], tv[p][4 * i + 3]);
        };
        SW::walk(smem, round,
                 (G::kRingInX ? round + 1 : walk.rounds) * G::NCH, tid, w2,
                 [&](uint32_t b, int) {
          const float4* wc = reinterpret_cast<const float4*>(ring + b);
          expand_project_f32<G>(t_at, pacc, wc, wc + G::W2_BYTES / 16, slope,
                                lane);
        });
        // the tile worked out again (it is not held across the chunks)
        store_row_f32<G>(pacc, xc, x, gns, out, walk.at(round, B, H, W),
                         warp, H, W, lane, cr);
        if constexpr (G::kParkT) {
          // every warp is done with t (kRingInX: and with the ring's
          // stages); a ragged tile's channels past cr are zero again where
          // t lay, and with one tile buffer the next tile lands there
          __syncthreads();
          if constexpr (G::kRagged) {
#pragma unroll
            for (int v = 0; v < C / 8; ++v)
              tq[v * NT] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
          if constexpr (G::NXBUF == 1) {
            if (more) {
              if constexpr (G::kRagged) __syncthreads();
              start_copies(landing(0), walk.at(round + 1, B, H, W));
            }
          }
        }
      } else {
        if constexpr (G::NXBUF == 1) {
          if (more) {
            __syncthreads();  // the only tile buffer is free again
            start_copies(landing(buf), walk.at(round + 1, B, H, W));
          }
        }
        products_store_f32<G>(tv, xc, reinterpret_cast<const float4*>(w2s),
                              reinterpret_cast<const float4*>(w3s), gns, out,
                              t, warp, H, W, slope, lane, cr);
      }
    }
  }
  // no block leaves while the cluster's others may still arrive on its
  // barriers
  if constexpr (G::NCL > 1) bid_ring::sync_cluster<G::NCL>();
}

// Launch with a persistent grid: as many blocks (clusters) as fit on the
// card at once (occupancy for this instantiation's shared memory), capped
// at the number of tiles (rounds of NCL tiles). The shared-memory attribute
// and the occupancy are set and queried once per instantiation and device.
constexpr int kMaxDevices = 64;

// Raise the kernel's dynamic shared-memory limit on the current device and
// return the blocks of it that one SM holds at once and, for a cluster of
// G::NCL blocks, the clusters the card holds (else the blocks it holds)
template <typename G, typename Kern>
int resident_units(Kern kern, int* blocks_per_sm, int* units) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern,
                                                    G::NT, G::SMEM);
  if (e != cudaSuccess) return (int)e;
  if constexpr (G::NCL == 1) {
    *units = *blocks_per_sm * bid::sm_count();
    return 0;
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G::NCL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(G::NCL, 1, 1);
    cfg.blockDim = dim3(G::NT, 1, 1);
    cfg.dynamicSmemBytes = G::SMEM;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaOccupancyMaxActiveClusters(units, kern, &cfg);
  }
}

// Launch `kern`, whose layout is G, over the tiles of [B, H, W]: a plain
// launch, or one of clusters of G::NCL blocks (cudaLaunchKernelEx; a
// refused launch returns its error)
template <typename G, typename T, typename Kern>
int launch_kernel(Kern kern, const void* x, void* out, const void* dw,
                  const void* ln, const void* w2, const void* w3,
                  const void* gain, int B, int H, int W, int cr, float slope,
                  float s_in, float inv_out, cudaStream_t stream) {
  using S = typename G::S;
  static int units_per_device[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return (int)de;
  if (dev < 0 || dev >= kMaxDevices) return BID_ERR_UNSUPPORTED;
  int& max_units = units_per_device[dev];
  if (max_units == 0) {
    int occ = 0, units = 0;
    const int e = resident_units<G>(kern, &occ, &units);
    if (e != 0) return e;
    if (occ < 1 || units < 1) return BID_ERR_UNSUPPORTED;
    max_units = units;
  }
  const long long tiles = (long long)B * ((H + G::TH - 1) / G::TH) *
                          ((W + G::TW - 1) / G::TW);
  if (tiles == 0) return 0;
  const long long pairs = (tiles + G::NCL - 1) / G::NCL;
  // the kernel counts tiles (its grid stride is added once more) and a
  // block's chunks in 32 bits
  if (tiles > INT_MAX - (long long)(max_units + 1) * G::NCL ||
      (pairs / max_units + 1) * G::NCH > INT_MAX)
    return BID_ERR_UNSUPPORTED;
  const int grid = (int)(pairs < max_units ? pairs : max_units) * G::NCL;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const float* dwt = static_cast<const float*>(dw);
  const float* lnt = static_cast<const float*>(ln);
  const S* w2t = static_cast<const S*>(w2);
  const S* w3t = static_cast<const S*>(w3);
  const float* gt = static_cast<const float*>(gain);
  if constexpr (G::NCL == 1) {
    kern<<<grid, G::NT, G::SMEM, stream>>>(xt, ot, dwt, lnt, w2t, w3t, gt, B,
                                           H, W, cr, 1.f / (float)cr, slope,
                                           s_in, inv_out);
  } else {
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = G::NCL;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(grid, 1, 1);
    cfg.blockDim = dim3(G::NT, 1, 1);
    cfg.dynamicSmemBytes = G::SMEM;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, kern, xt, ot, dwt, lnt, w2t, w3t, gt, B, H,
                           W, cr, 1.f / (float)cr, slope, s_in, inv_out);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// shared memory, registers, local (spill) bytes, threads per block,
// resident blocks per SM, cluster size, the blocks (clusters) the card
// holds at once, the layout's width and the weight ring's stages (0: no
// ring) of one kernel, as v[0..8]
template <typename G, typename Kern>
int kernel_info(Kern kern, int* v) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kern);
  if (e != cudaSuccess) return (int)e;
  v[0] = (int)G::SMEM;
  v[1] = a.numRegs;
  v[2] = (int)a.localSizeBytes;
  v[3] = G::NT;
  v[5] = G::NCL;
  v[7] = G::C;
  v[8] = G::kStream ? G::NS : 0;
  return resident_units<G>(kern, &v[4], &v[6]);
}

// the kernel of one (C, K) of its own (RG false) or of a class (RG true)
template <typename T, int C, int K, bool RG = false>
int launch(const void* x, void* out, const void* dw, const void* ln,
           const void* w2, const void* w3, const void* gain, int B, int H,
           int W, int cr, float slope, float s_in, float inv_out,
           cudaStream_t stream) {
  return launch_kernel<Cfg<T, C, K, RG>, T>(
      convnext_block_kernel<T, C, K, RG>, x, out, dw, ln, w2, w3, gain, B, H,
      W, cr, slope, s_in, inv_out, stream);
}

template <typename T, int C, int K, bool RG = false>
int info(int* v) {
  return kernel_info<Cfg<T, C, K, RG>>(convnext_block_kernel<T, C, K, RG>, v);
}

}  // namespace

namespace bid_k1 {

// The class kernels of every C up to 128 at K = 1, 3, 5 (convnext_class.cu,
// the layouts of width C rounded up to 16 over the sources of
// convnext_class.cuh) and the wide class, 128 < C <= 256
// (convnext_wide.cu), at K = 1, 3, 5, 7: a launch, and an instantiation's
// info as bid_convnext_block_info gives it, by dtype code (0 float32, 1
// bfloat16, 2 int8)
int launch_class(int dtype, const void* x, void* out, const void* dw,
                 const void* ln, const void* w2, const void* w3,
                 const void* gain, int B, int H, int W, int C, int K,
                 float slope, float s_in, float inv_out, cudaStream_t s);
int info_class(int dtype, int C, int K, int* v);
// K = 7 at C <= 128: (32, 7), (64, 7), (128, 7) of their own
// (convnext_k7.cu) and the class layouts (convnext_k7_class.cu,
// convnext_k7_class_80.cu, convnext_k7_class_112.cu; dispatched in
// convnext_class.cu)
int launch_k7(int dtype, const void* x, void* out, const void* dw,
              const void* ln, const void* w2, const void* w3,
              const void* gain, int B, int H, int W, int C, float slope,
              float s_in, float inv_out, cudaStream_t s);
int info_k7(int dtype, int C, int* v);
int launch_k7_class(int dtype, const void* x, void* out, const void* dw,
                    const void* ln, const void* w2, const void* w3,
                    const void* gain, int B, int H, int W, int C, float slope,
                    float s_in, float inv_out, cudaStream_t s);
int info_k7_class(int dtype, int C, int* v);
int launch_wide(int dtype, const void* x, void* out, const void* dw,
                const void* ln, const void* w2, const void* w3,
                const void* gain, int B, int H, int W, int C, int K,
                float slope, float s_in, float inv_out, cudaStream_t s);
int info_wide(int dtype, int C, int K, int* v);
// a thread-block cluster, by I/O type T: every C from 129 to 1024
// (convnext_cluster.cuh; built per type by convnext_cluster.cu,
// convnext_cluster_int8.cu and convnext_cluster_f32.cu)
template <typename T>
int launch_cluster_unit(const void* x, void* out, const void* dw,
                        const void* ln, const void* w2, const void* w3,
                        const void* gain, int B, int H, int W, int C, int K,
                        float slope, float s_in, float inv_out,
                        cudaStream_t s);
template <typename T>
int info_cluster_unit(int C, int K, int* v);
// the general route (convnext_general.cuh, built by convnext_general.cu):
// any C >= 1, odd K >= 1 and E >= 1 in every I/O mode, as three kernels
// through ``scratch`` (general_scratch_bytes of it at least, on 256 bytes);
// dw is [K * K][C] f32, W2 [E][C] and W3 [C][E] as they lie
int launch_general(int dtype, const void* x, void* out, const void* dw,
                   const void* ln, const void* w2, const void* w3,
                   const void* gain, void* scratch, long long scratch_bytes,
                   int B, int H, int W, int C, int K, int E, float slope,
                   float s_in, float inv_out, cudaStream_t s);
int info_general(int dtype, int C, int* v);
long long general_scratch_bytes(long long P, int C, int E, int dtype);

}  // namespace bid_k1
