// CRC-16-CCITT-FALSE over rows of decoded bits, and the soft decode's
// body gate and packing in the same launch.
//
// Replaces no TPU kernel.  The JAX package runs this CRC as a lax.scan
// over bytes (webaudio_modem_tpu/ops/soft_fsk.py `_crc16_bits_device`),
// which XLA compiles into its program; the port ran the same table
// recurrence eagerly, seven tiny launches a byte (~930 a 133-byte body
// batch).  Two entries share one device function:
//
//   wam_crc_rows   bits u8 [R, n] (0 / 1, MSB first; any two strides)
//                  -> crc i32 [R], any n, a tail of fewer than 8 bits too
//   wam_crc_pack   bodies u8 [B, 8 (pl + 2)] (K3's decoded bits, read in
//                  place: bit i of row b at i * B + b), found u8 [B]
//                  -> packed u8 [B, pl + 1]: the pl payload bytes, then
//                  found AND (the CRC of the payload bits equals the
//                  trailing two bytes)
//
// The arithmetic.  Poly P = x^16 + x^12 + x^5 + 1, init 0xFFFF, no final
// XOR.  The bit-serial register update r <- r x + b x^16 (mod P) is
// linear, so over the bits b_0 .. b_{n-1}
//
//   crc = 0xFFFF x^n + sum_i b_i x^(16 + n - 1 - i)   (mod P).
//
// Each bit adds a constant of its position where it is 1: no chain runs
// through the bits, and any split of a row into segments combines by
// XOR.  Along a segment the constant steps by x^-1 (P(0) = 1, so x is a
// unit): g odd -> (g >> 1) ^ 0x8810, g even -> g >> 1.  The host gives
// the first constant of each segment and 0xFFFF x^n (`CrcPlan`).  The
// gate needs no compare with the trailer: the register over the payload
// and its two CRC bytes is (crc(payload) ^ trailer) x^16 mod P, zero iff
// the two are equal, x^16 being a unit too.  So the gate is the same
// function over all 8 (pl + 2) bits, tested against 0.
//
// What bounds it on an H100: one read of each bit byte and one write of
// each packed byte, no arithmetic worth counting.  At B = 4096, pl = 133
// that is 4.42 MB in and 0.55 MB out, 1.5 us at 3.35 TB/s: the launch
// and the loads' latency, not the bandwidth, set the time.
//
// Design.  A block owns 32 rows (lane = row, so at one bit the lanes of
// a warp read 32 consecutive bytes of K3's [T, B] plane, one sector) and
// one warp per segment of a row (up to 32; a segment is a whole number
// of bytes), so a 133-byte body runs 27 warps of 5 bytes each and every
// bit load of a segment goes out a byte at a time, 8 in flight per
// thread.  Partial CRCs meet in shared memory; warp 0 XORs them.  The
// packed bytes gather in a shared tile of the block's 32 rows, which is
// one contiguous run of the output, stored coalesced at the end.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kRows = 32;       // rows a block: one a lane
constexpr int kMaxSeg = 32;     // segments a row: one a warp

// Filled by the host (ops/kernels/crc16.py `_plan`), passed by value.
// Outside the unnamed namespace: the C entries take it, and a type of
// internal linkage in their signatures would keep them out of the
// library's symbols.
struct CrcPlan {
  int32_t n_bits;              // bits a row
  int32_t seg_bits;            // bits a segment, a multiple of 8
  int32_t n_seg;               // segments, warps a block
  uint32_t init;               // 0xFFFF x^n_bits mod P
  uint32_t g0[kMaxSeg];        // x^(16 + n_bits - 1 - s seg_bits) mod P
};

namespace {

// One segment of one row: XOR of the constants of its 1 bits; with
// kPack, its whole bytes below `pl` stored into the row's tile.
template <bool kPack>
__device__ __forceinline__ uint32_t segment_crc(
    const uint8_t* __restrict__ p, long long s_bit, int i0, int i1,
    uint32_t g, int pl, uint8_t* tile_row) {
  uint32_t acc = 0;
  int i = i0;
  for (; i + 8 <= i1; i += 8) {
    uint32_t b[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) b[k] = p[k * s_bit];
    p += 8 * s_bit;
    uint32_t byte = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc ^= g & (0u - b[k]);
      g = (g >> 1) ^ (0x8810u & (0u - (g & 1u)));
      byte = (byte << 1) | b[k];
    }
    if (kPack && (i >> 3) < pl) {
      tile_row[i >> 3] = static_cast<uint8_t>(byte);
    }
  }
  for (; i < i1; ++i, p += s_bit) {     // a tail of fewer than 8 bits
    acc ^= g & (0u - static_cast<uint32_t>(*p));
    g = (g >> 1) ^ (0x8810u & (0u - (g & 1u)));
  }
  return acc;
}

template <bool kPack>
__global__ void __launch_bounds__(kRows * kMaxSeg)
crc_kernel(const uint8_t* __restrict__ bits, int R, long long s_row,
           long long s_bit, CrcPlan plan, const uint8_t* __restrict__ found,
           int pl, uint8_t* __restrict__ packed,
           int32_t* __restrict__ crc_out) {
  extern __shared__ uint32_t smem[];
  uint32_t* part = smem;                                // [n_seg][kRows]
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem + plan.n_seg * kRows);
  const int lane = threadIdx.x % kRows;
  const int seg = threadIdx.x / kRows;
  const int r0 = blockIdx.x * kRows;
  const int r = r0 + lane;
  const int i0 = seg * plan.seg_bits;
  const int i1 = min(i0 + plan.seg_bits, plan.n_bits);
  uint32_t acc = 0;
  if (r < R) {
    acc = segment_crc<kPack>(
        bits + static_cast<long long>(r) * s_row +
            static_cast<long long>(i0) * s_bit,
        s_bit, i0, i1, plan.g0[seg], pl, tile + lane * (pl + 1));
  }
  part[seg * kRows + lane] = acc;
  __syncthreads();
  if (seg == 0 && r < R) {
    uint32_t crc = plan.init;
    for (int s = 0; s < plan.n_seg; ++s) crc ^= part[s * kRows + lane];
    if (kPack) {
      tile[lane * (pl + 1) + pl] = found[r] != 0 && crc == 0;
    } else {
      crc_out[r] = static_cast<int32_t>(crc);
    }
  }
  if (kPack) {
    __syncthreads();
    const int n = min(kRows, R - r0) * (pl + 1);
    uint8_t* dst = packed + static_cast<long long>(r0) * (pl + 1);
    for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = tile[k];
  }
}

template <bool kPack>
int launch(const uint8_t* bits, int R, long long s_row, long long s_bit,
           const CrcPlan* plan, const uint8_t* found, int pl,
           uint8_t* packed, int32_t* crc_out, void* stream) {
  const size_t smem = sizeof(uint32_t) * plan->n_seg * kRows +
                      (kPack ? static_cast<size_t>(kRows) * (pl + 1) : 0);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(crc_kernel<kPack>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  crc_kernel<kPack><<<(R + kRows - 1) / kRows, kRows * plan->n_seg, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      bits, R, s_row, s_bit, *plan, found, pl, packed, crc_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bits u8: bit i of row r at r * s_row + i * s_bit; crc i32 [R].
// Launches on `stream` and returns cudaGetLastError().
extern "C" int wam_crc_rows(const uint8_t* bits, int R, long long s_row,
                            long long s_bit, const CrcPlan* plan,
                            int32_t* crc, void* stream) {
  return launch<false>(bits, R, s_row, s_bit, plan, nullptr, 0, nullptr,
                       crc, stream);
}

// bodies u8 with plan->n_bits = 8 (pl + 2) bits a row; found u8 [B];
// packed u8 [B, pl + 1].
extern "C" int wam_crc_pack(const uint8_t* bodies, int B, long long s_row,
                            long long s_bit, const CrcPlan* plan,
                            const uint8_t* found, int pl, uint8_t* packed,
                            void* stream) {
  return launch<true>(bodies, B, s_row, s_bit, plan, found, pl, packed,
                      nullptr, stream);
}
