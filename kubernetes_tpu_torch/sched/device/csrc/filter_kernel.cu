// The predicate-filter kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kubernetes_tpu/sched/device/pallas_filter.py
// (_filter_kernel, called through _filter_call): the [P, N] predicate-fit
// mask of P pending pods against N nodes and the pre-batch state, for the
// extender Filter verb. Same function, not the same blocking: the TPU
// kernel padded both axes to 8 x 512 tiles and wrote int32; this one masks
// its own ragged edge and writes one byte per element into a torch.bool
// tensor.
//
// Bound: bytes. The bool output (P * N bytes) dominates the traffic; the
// node and pod inputs are a few hundred KB at the extender's shapes
// (P = 8192, N = 5000: 41 MB out, ~12 us at 3.35 TB/s). So:
//   - one thread per (pod, node) element, nodes on threadIdx.x: a warp
//     writes 32 consecutive output bytes and reads 32 consecutive node
//     entries of every node vector;
//   - node bitsets are read in their natural [N, W] layout. With W = 1
//     word (the common case: fewer than 33 distinct labels / host ports /
//     disks) that is coalesced; for W > 1 the reads stride by W words, but
//     node bitsets are ~1/1000 of the output bytes and stay in L1/L2, so a
//     transpose launch in the wrapper would cost more than it saves;
//   - each block stages the bitset words of its FILTER_BLOCK_PODS pod rows
//     in shared memory once; pod scalars are warp-uniform broadcast loads.
//
// Resource comparisons stay in int32 (cap - used >= req), as in the TPU
// kernel: the encoder only narrows when its bounds guarantee no overflow.
// Bitsets arrive as int32 views of uint32 words and are read as uint32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; filter_masks_launch is the plain-C entry point that
// kubernetes_tpu_torch/sched/device/filter_kernel.py calls through ctypes.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#define FILTER_BLOCK_NODES 128
#define FILTER_BLOCK_PODS 8

__global__ void __launch_bounds__(FILTER_BLOCK_NODES * FILTER_BLOCK_PODS)
filter_kernel(int P, int N, int LW, int PW, int KW,
              // node axis [N] / [N, W]
              const uint8_t* __restrict__ valid,
              const int32_t* __restrict__ cpu_cap,
              const int32_t* __restrict__ mem_cap,
              const int32_t* __restrict__ pod_cap,
              const uint8_t* __restrict__ exceed_cpu,
              const uint8_t* __restrict__ exceed_mem,
              const uint8_t* __restrict__ static_mask,
              const uint32_t* __restrict__ labels,
              const int32_t* __restrict__ cpu_used,
              const int32_t* __restrict__ mem_used,
              const int32_t* __restrict__ pod_count,
              const uint32_t* __restrict__ port_bits,
              const uint32_t* __restrict__ disk_any,
              const uint32_t* __restrict__ disk_rw,
              // pod axis [P] / [P, W]
              const uint8_t* __restrict__ pvalid,
              const int32_t* __restrict__ preq_cpu,
              const int32_t* __restrict__ preq_mem,
              const uint8_t* __restrict__ pzero,
              const uint32_t* __restrict__ psel,
              const uint32_t* __restrict__ pports,
              const uint32_t* __restrict__ pqany,
              const uint32_t* __restrict__ pqrw,
              const int32_t* __restrict__ phost,
              uint8_t* __restrict__ out) {
  // shared row layout per pod: [sel LW][ports PW][qany KW][qrw KW]
  extern __shared__ uint32_t pod_words[];
  const int row_words = LW + PW + 2 * KW;
  const int pod0 = blockIdx.y * FILTER_BLOCK_PODS;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < FILTER_BLOCK_PODS * row_words;
       i += blockDim.x * blockDim.y) {
    const int r = i / row_words;
    int c = i - r * row_words;
    const int p = pod0 + r;
    uint32_t v = 0;
    if (p < P) {
      if (c < LW) {
        v = psel[(size_t)p * LW + c];
      } else if ((c -= LW) < PW) {
        v = pports[(size_t)p * PW + c];
      } else if ((c -= PW) < KW) {
        v = pqany[(size_t)p * KW + c];
      } else {
        v = pqrw[(size_t)p * KW + (c - KW)];
      }
    }
    pod_words[i] = v;
  }
  __syncthreads();

  const int node = blockIdx.x * blockDim.x + threadIdx.x;
  const int pod = pod0 + threadIdx.y;
  if (node >= N || pod >= P) return;
  const uint32_t* sel = pod_words + threadIdx.y * row_words;
  const uint32_t* ports = sel + LW;
  const uint32_t* qany = ports + PW;
  const uint32_t* qrw = qany + KW;

  // PodFitsResources (predicates.go:192-222)
  const bool fits_count = pod_count[node] < pod_cap[node];
  const int32_t cc = cpu_cap[node];
  const int32_t cm = mem_cap[node];
  const bool free_cpu = (cc == 0) || (cc - cpu_used[node] >= preq_cpu[pod]);
  const bool free_mem = (cm == 0) || (cm - mem_used[node] >= preq_mem[pod]);
  const bool not_exceeded = !exceed_cpu[node] && !exceed_mem[node];
  const bool res_ok =
      fits_count && (pzero[pod] || (not_exceeded && free_cpu && free_mem));

  // PodFitsHostPorts (predicates.go:403-415)
  uint32_t port_acc = 0;
  for (int w = 0; w < PW; ++w)
    port_acc |= port_bits[(size_t)node * PW + w] & ports[w];

  // MatchNodeSelector (predicates.go:250, label bitsets)
  uint32_t sel_acc = 0;
  for (int w = 0; w < LW; ++w)
    sel_acc |= sel[w] & ~labels[(size_t)node * LW + w];

  // NoDiskConflict (predicates.go:127-137)
  uint32_t disk_acc = 0;
  for (int w = 0; w < KW; ++w)
    disk_acc |= (disk_any[(size_t)node * KW + w] & qany[w]) |
                (disk_rw[(size_t)node * KW + w] & qrw[w]);

  // PodFitsHost (predicates.go:258)
  const int32_t host = phost[pod];
  const bool host_ok = (host == -1) || (host == node);

  const bool fit = valid[node] && pvalid[pod] && res_ok && port_acc == 0 &&
                   sel_acc == 0 && disk_acc == 0 && host_ok &&
                   static_mask[node];
  out[(size_t)pod * N + node] = fit ? 1 : 0;
}

extern "C" int filter_masks_launch(
    int P, int N, int LW, int PW, int KW, const void* valid,
    const void* cpu_cap, const void* mem_cap, const void* pod_cap,
    const void* exceed_cpu, const void* exceed_mem, const void* static_mask,
    const void* labels, const void* cpu_used, const void* mem_used,
    const void* pod_count, const void* port_bits, const void* disk_any,
    const void* disk_rw, const void* pvalid, const void* preq_cpu,
    const void* preq_mem, const void* pzero, const void* psel,
    const void* pports, const void* pqany, const void* pqrw,
    const void* phost, void* out, void* stream) {
  const dim3 block(FILTER_BLOCK_NODES, FILTER_BLOCK_PODS);
  const dim3 grid((N + FILTER_BLOCK_NODES - 1) / FILTER_BLOCK_NODES,
                  (P + FILTER_BLOCK_PODS - 1) / FILTER_BLOCK_PODS);
  const size_t shmem =
      (size_t)FILTER_BLOCK_PODS * (LW + PW + 2 * KW) * sizeof(uint32_t);
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  filter_kernel<<<grid, block, shmem, (cudaStream_t)stream>>>(
      P, N, LW, PW, KW, (const uint8_t*)valid, (const int32_t*)cpu_cap,
      (const int32_t*)mem_cap, (const int32_t*)pod_cap,
      (const uint8_t*)exceed_cpu, (const uint8_t*)exceed_mem,
      (const uint8_t*)static_mask, (const uint32_t*)labels,
      (const int32_t*)cpu_used, (const int32_t*)mem_used,
      (const int32_t*)pod_count, (const uint32_t*)port_bits,
      (const uint32_t*)disk_any, (const uint32_t*)disk_rw,
      (const uint8_t*)pvalid, (const int32_t*)preq_cpu,
      (const int32_t*)preq_mem, (const uint8_t*)pzero,
      (const uint32_t*)psel, (const uint32_t*)pports,
      (const uint32_t*)pqany, (const uint32_t*)pqrw, (const int32_t*)phost,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* filter_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
