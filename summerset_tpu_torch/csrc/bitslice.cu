// Bit-sliced GF(2^8) matrix product on packed 32-bit lanes, for Hopper.
//
// Replaces the Pallas TPU kernel summerset_tpu/ops/rscoding.py
// _bitslice_matmul_pallas (body _bitslice_kernel).  For every lane l of
// every batch item b:
//
//   out[b, r, l] = XOR over c < cols, i < 8 of
//                  ((x[b, c, l] >> i) & 0x01010101) * tbl[r, c, i]
//
// Each 32-bit lane holds 4 shard bytes; tbl[r, c, i] is the byte
// M[r, c] * 2^i in GF(2^8), so the product replicates it into exactly the
// bytes whose bit i is set, with no carry across bytes.  The arithmetic is
// uint32 (signed overflow is undefined in C++); the bits equal the JAX
// int32 kernel's, whose arithmetic shift fills only bits the mask drops.
//
// Bound: per lane the kernel reads cols words and writes rows words and
// does cols * 8 * (2 + 2 * rows) integer operations, so at RS(3,2) it is
// bound by the integer rate, not by memory.  Design: one thread per output
// lane, the small table in shared memory (every thread reads the same
// entry, a broadcast), neighbouring threads on neighbouring lanes so
// loads and stores coalesce, a masked tail for any L.  Simple first: a
// faster kernel is later work.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void bitslice_gf256_kernel(const uint32_t* __restrict__ tbl,
                                      const uint32_t* __restrict__ x,
                                      uint32_t* __restrict__ out,
                                      long long B, int rows, int cols,
                                      long long L) {
  extern __shared__ uint32_t stbl[];
  const int n = rows * cols * 8;
  for (int k = threadIdx.x; k < n; k += blockDim.x) stbl[k] = tbl[k];
  __syncthreads();

  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * L) return;
  const long long b = idx / L;
  const long long l = idx - b * L;
  const uint32_t* xb = x + b * cols * L + l;
  uint32_t* ob = out + b * rows * L + l;
  for (int r = 0; r < rows; ++r) {
    uint32_t acc = 0u;
    for (int c = 0; c < cols; ++c) {
      const uint32_t xc = xb[(long long)c * L];
      const uint32_t* t = stbl + (r * cols + c) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc ^= ((xc >> i) & 0x01010101u) * t[i];
    }
    ob[(long long)r * L] = acc;
  }
}

// Launch on `stream` of device `device`; returns cudaGetLastError().
extern "C" int bitslice_gf256(const void* tbl, const void* x, void* out,
                              long long B, int rows, int cols, long long L,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = B * L;
  if (total <= 0) return (int)cudaErrorInvalidValue;  // the wrapper skips empty calls
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)rows * cols * 8 * sizeof(uint32_t);
  bitslice_gf256_kernel<<<(unsigned int)blocks, threads, smem,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)tbl, (const uint32_t*)x, (uint32_t*)out, B, rows,
      cols, L);
  return (int)cudaGetLastError();
}
