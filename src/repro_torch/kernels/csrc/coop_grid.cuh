// The grid of a cooperative kernel that runs one block on each SM, shared
// by greedy.cu, celf.cu and membership.cu: the checks that such a grid can
// be launched, read once a card by the caller.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

constexpr int kMaxDevices = 64;

// One block of `threads` on each SM of card `device` for a kernel in two
// forms: `with_shared` gets its dynamic shared memory limit raised to all
// that a block may have beside its static shared memory (*bytes, a
// multiple of 16); a block of it at that size, and of `without` at
// `without_bytes_a_block` bytes a block of the grid, must stay resident.
inline cudaError_t one_block_an_sm(const void* with_shared,
                                   const void* without, int threads,
                                   int without_bytes_a_block, int device,
                                   int* sms, int64_t* bytes) {
  int coop = 0, count = 0, optin = 0, resident = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, with_shared);
  if (err != cudaSuccess) return err;
  const int limit = (optin - int(attr.sharedSizeBytes)) & ~15;
  err = cudaFuncSetAttribute(with_shared,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, with_shared,
                                                      threads, limit);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &resident, without, threads, size_t(without_bytes_a_block) * count);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  *sms = count;
  *bytes = limit;
  return cudaSuccess;
}

// One block of `threads` on each SM of card `device` for `kernel`, which
// takes no dynamic shared memory: the SM count in *sms when a block of it
// stays resident and the card launches cooperatively.
inline cudaError_t cooperative_sms(const void* kernel, int threads,
                                   int device, int* sms) {
  int coop = 0, count = 0, resident = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      threads, 0);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorCooperativeLaunchTooLarge;
  *sms = count;
  return cudaSuccess;
}
