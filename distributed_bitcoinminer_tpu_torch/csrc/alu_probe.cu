// K7, the INT32 ALU ceiling probe, hand-written for Hopper. It replaces the
// TPU kernel of the JAX package's on-chip tuning tool, scripts/tpu_tune.py::
// vpu_kernel (its pallas_call at :69), and computes what that computes: 8
// independent chains per lane, chain c starting at the lane's column in the
// TPU's (8, 128) tile plus c, each iteration i setting
// x = (((x >> 7) | (x << 25)) ^ x) + (i + x) with uint32 wraparound, and
// after `iters` iterations the xor of the 8 chains, written once per lane.
// A thread is a lane and takes threadIdx.x % 128 as its column, so every
// 128 threads compute the TPU tile's row, and the first 1,024 outputs are
// comparable with that tile.
//
// What bounds it: instruction issue, by design. The loop reads and writes
// no memory. Per chain and iteration the rotate is one funnel shift (SHF),
// the xor one LOP3 and the two adds one IADD3 on Hopper, so the TPU
// script's 48 operations an iteration need 24 instructions here, plus the
// loop's own; the compiler moves some adds to the FMA pipe as IMADs, which
// the tuning tool's opcode count of the loop shows. The loop stays rolled (`#pragma unroll 1`), so that its
// SASS body is one iteration, which the tuning tool counts with cuobjdump;
// the 8 chains give each warp 8 independent instructions to issue back to
// back. The launch fills every SM at full occupancy, as many waves as the
// caller asks, so that the rate it measures is the card's sustained issue
// rate for this mix of INT32 instructions.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// One lane's value: the 8 chains from column col, `iters` iterations, xor.
// Host and device code: the CPU tests compile it with a host C++ compiler.
__host__ __device__ __forceinline__ uint32_t probe_lane(uint32_t col,
                                                        uint32_t iters) {
  uint32_t x[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = col + static_cast<uint32_t>(c);
#pragma unroll 1
  for (uint32_t i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint32_t r = (x[c] >> 7) | (x[c] << 25);
      x[c] = (r ^ x[c]) + (i + x[c]);
    }
  }
  uint32_t acc = x[0];
#pragma unroll
  for (int c = 1; c < 8; ++c) acc ^= x[c];
  return acc;
}

// ------------------------------------------------------------ kernels

__global__ void __launch_bounds__(kThreads)
    alu_probe_kernel(uint32_t iters, uint32_t* __restrict__ out) {
  const uint32_t lane = blockIdx.x * blockDim.x + threadIdx.x;
  out[lane] = probe_lane(threadIdx.x % 128u, iters);
}

}  // namespace

extern "C" {

// Threads per block, and resident blocks per SM (0 on error).
int dbmt_alu_probe_threads() { return kThreads; }

int dbmt_alu_probe_blocks_per_sm() {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, alu_probe_kernel, kThreads, 0);
  return err == cudaSuccess ? per_sm : 0;
}

// The probe over `grid` blocks; out: grid * threads device words. Enqueues
// on `stream` without synchronising; returns cudaGetLastError().
int dbmt_alu_probe(uint32_t iters, int grid, uint32_t* out, void* stream) {
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  alu_probe_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
