// One hop through L2 between two SMs, for Hopper (sm_90a): the latency
// floor of K7, the exchange between the shards of the sharded K1
// (kubernetes_tpu_torch/sched/device/csrc/scan_kernel.cu). A probe, not
// a kernel of the port: kubemark/profile_kernels.py (l2_hop) builds it
// on its own and nothing links it into the port's kernels.
//
// A grid of one CTA an SM (each asks for more than half an SM's shared
// memory); the CTA on SM `ping` and the CTA on SM `pong` pass one 8-byte
// word back and forth `rounds` times through a buffer in global memory,
// each spinning on the other's word; every other CTA returns at once.
// The pinger's clock64 over the rounds, over 2 x rounds, is one one-way
// hop in cycles. Two ways to pass it:
//   mode 0: flag-in-data, as K7 posts a record now: one relaxed .gpu
//           64-bit store of (round << 32 | payload), polled with relaxed
//           .gpu loads until the high word is the round;
//   mode 1: sequence then payload, as K7 posted before: the payload
//           relaxed, then the round with st.release.gpu; the reader
//           spins with ld.acquire.gpu on the round, then loads the
//           payload (a second dependent trip).
// out[0] the pinger's cycles, out[1] the payload sum (checked by the
// caller), out[2] and out[3] the two CTAs' SM ids (-1 where no CTA ran
// on that SM). A spin past `budget` cycles gives up and leaves out[0]
// at -1. Mode 2 is the census: CTA b writes its SM id into out[b] (SM
// ids need not be contiguous; the caller picks its pairs from these).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; l2_hop_launch is the plain-C entry point.

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned smid() {
  unsigned r;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint64_t gaddr(const void* p) {
  return (uint64_t)__cvta_generic_to_global(p);
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(gaddr(p)), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(gaddr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(gaddr(p)), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(gaddr(p)) : "memory");
  return v;
}

// send round r's payload v into `box` (two words: [0] the flag-in-data
// word or the sequence, [1] mode 1's payload)
__device__ __forceinline__ void send(unsigned long long* box, int mode,
                                     unsigned r, unsigned v) {
  if (mode == 0) {
    st_relaxed(box, (unsigned long long)r << 32 | v);
  } else {
    st_relaxed(box + 1, v);
    st_release(box, r);
  }
}

// wait for round r in `box` -> its payload; false past the budget
__device__ __forceinline__ bool receive(const unsigned long long* box,
                                        int mode, unsigned r,
                                        long long budget, unsigned* v) {
  const long long t0 = clock64();
  if (mode == 0) {
    unsigned long long w;
    while ((unsigned)((w = ld_relaxed(box)) >> 32) != r)
      if (clock64() - t0 > budget) return false;
    *v = (unsigned)w;
  } else {
    while (ld_acquire(box) != r)
      if (clock64() - t0 > budget) return false;
    *v = (unsigned)ld_relaxed(box + 1);
  }
  return true;
}

__global__ void l2_hop_kernel(unsigned long long* buf, int ping, int pong,
                              int mode, int rounds, long long budget,
                              long long* out) {
  extern __shared__ unsigned char pad[];
  const int sm = (int)smid();
  if (mode == 2) {
    if (threadIdx.x == 0) out[blockIdx.x] = sm;
    return;
  }
  if (threadIdx.x != 0 || (sm != ping && sm != pong)) return;
  pad[0] = 0;
  // boxes 32 words apart (separate lines): the pinger writes [0], the
  // ponger [32]
  unsigned long long* mine = buf + (sm == ping ? 0 : 32);
  unsigned long long* theirs = buf + (sm == ping ? 32 : 0);
  out[sm == ping ? 2 : 3] = sm;
  long long sum = 0;
  const long long t0 = clock64();
  for (int i = 1; i <= rounds; ++i) {
    unsigned v = 0;
    if (sm == ping) {
      send(mine, mode, (unsigned)i, (unsigned)i * 7u);
      if (!receive(theirs, mode, (unsigned)i, budget, &v)) return;
    } else {
      if (!receive(theirs, mode, (unsigned)i, budget, &v)) return;
      send(mine, mode, (unsigned)i, v + 1);
    }
    sum += v;
  }
  if (sm == ping) {
    out[0] = clock64() - t0;
    out[1] = sum;
  }
}

// buf: 64 zeroed int64 words; out: 4 int64 words (`sms` for the
// census); the grid: `sms`
// CTAs of 32 threads, each with `smem` bytes of dynamic shared memory
// (more than half of an SM's, so one CTA an SM)
extern "C" int l2_hop_launch(void* buf, int sms, int smem, int ping,
                             int pong, int mode, int rounds,
                             long long budget, void* out, void* stream) {
  if (sms < 2 || ping == pong || ping < 0 || pong < 0 || rounds < 1
      || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      l2_hop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  l2_hop_kernel<<<sms, 32, smem, (cudaStream_t)stream>>>(
      (unsigned long long*)buf, ping, pong, mode, rounds, budget,
      (long long*)out);
  return (int)cudaGetLastError();
}
