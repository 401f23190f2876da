// Bank-block -> slot-row relayout (K6) of the split tiled backward.
//
// Replaces dvren_tpu/ops/packed_transpose.py::banks_to_u16_rows
// (_b2r_kernel): K2's bank-block cotangents (B, 32, 128) f32, column-major
// per block (column c, lane l), become slot rows (B*128, 32), row
// s = block s / 128, lane s % 128. The TPU kernel split each 32-bit word
// into u16 halves for its gathers; here the rows stay f32 (as K3's table
// does) and equal hi << 16 | lo of its rows bit for bit.
//
// The data move as 32-bit words, never through float arithmetic, so NaN
// payloads, -0.0 and subnormals pass unchanged.
//
// One block of 256 threads per bank block: each warp reads whole columns
// (128 consecutive words, coalesced) into a shared tile whose rows are
// padded to 129 words, so that the transposed read, lane i taking column
// i of one slot row, hits 32 distinct shared-memory banks; each warp then
// writes whole 128-byte slot rows. One launch relays every tile group of
// a backward (K2 writes all their blocks into one array).
//
// Bound on the H100: bytes. Every word is read once and written once
// (the dense headline's 5,104 blocks: 167.2 MB in all, 0.0499 ms at
// 3.35 TB/s); 16.5 KB of shared memory per block keeps several blocks in
// flight on each SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;
constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kPad = kLanes + 1;

__global__ void __launch_bounds__(kThreads)
banks_to_rows_kernel(const uint32_t* __restrict__ banks,
                     uint32_t* __restrict__ rows) {
  __shared__ uint32_t tile[kCols * kPad];
  const int64_t b = blockIdx.x;
  const uint32_t* src = banks + b * kCols * kLanes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // column c, lanes lane + 32k: one 128-byte read per warp and k
#pragma unroll
  for (int i = 0; i < kCols * kLanes / kThreads; ++i) {
    const int e = i * kThreads + threadIdx.x;
    const int c = e / kLanes;
    const int l = e % kLanes;
    tile[c * kPad + l] = __ldg(src + e);
  }
  __syncthreads();
  // slot row r, column lane: one 128-byte write per warp and row
  uint32_t* dst = rows + b * kLanes * kCols;
#pragma unroll
  for (int r = warp; r < kLanes; r += kThreads / 32) {
    dst[r * kCols + lane] = tile[lane * kPad + r];
  }
}

}  // namespace

extern "C" int dvt_banks_to_rows(const void* banks, void* rows, int n_blocks,
                                 void* stream) {
  if (n_blocks > 0) {
    banks_to_rows_kernel<<<n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const uint32_t*>(banks), static_cast<uint32_t*>(rows));
  }
  return (int)cudaGetLastError();
}
