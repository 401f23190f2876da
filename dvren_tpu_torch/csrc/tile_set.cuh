// Shared device code of the tile kernels that launch once per schedule
// (K1 fused_tiles.cu, K2 fused_tiles_bwd.cu, K8f hash_grid.cu, K8b
// hash_grid_bwd.cu): a tile's place in its schedule's flat arrays, and the
// window slot of a sample's tile-local lane.
//
// A schedule's tile groups (ops/fused_tiles.py::TileSet) are concatenated
// in group order: samp (S_c, 3, 16, 128), bank0 (S_c * subs), the bank
// tables and base (S_b, ...), the backward's slot rows (S_b, 128, C) and
// optical-depth scratch (S_c * 8, 256). Ray planes, ke, the cotangents and
// the outputs are indexed by the tile itself. desc (T, 4) int32 holds per
// tile its chunk and bank counts and its first chunk and first bank.
#pragma once

#include <cstdint>

namespace dvt_tiles {

constexpr int kBankLanes = 128;   // slots per bank
constexpr int kDescWords = 4;     // nc, nb, first chunk, first bank

struct TileSpan {
  int nc, nb;
  int64_t chunk0, bank0;
};

// The empty asm keeps the four words in registers: without it the
// compiler reloads them from desc where they are used, inside the sample
// loop, so that each sample's slot address waits on a load (K8f then uses
// fewer registers and runs markedly slower).
__device__ __forceinline__ TileSpan tile_span(const int* desc, int64_t t) {
  const int* d = desc + t * kDescWords;
  TileSpan s;
  s.nc = d[0];
  s.nb = d[1];
  s.chunk0 = d[2];
  s.bank0 = d[3];
  asm volatile("" : "+r"(s.nc), "+r"(s.nb), "+l"(s.chunk0), "+l"(s.bank0));
  return s;
}

// The window slot of a tile-local lane relative to the window's first bank
// (idx2 = lane - b0 * 128): (clipped slot, second bank?).
__device__ __forceinline__ int window_slot(int idx2, bool* second) {
  *second = idx2 >= kBankLanes;
  return *second ? min(max(idx2 - kBankLanes, 0), kBankLanes - 1)
                 : min(max(idx2, 0), kBankLanes - 1);
}

}  // namespace dvt_tiles
