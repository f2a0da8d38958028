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
// Bound: 32-bit integer operations. Every term is an integer compare or
// bitset AND / OR; at P = 8192, N = 5000 with one word a bitset the
// function counts 11 instructions an element (bounds.filter_ops:
// compares with their predicate-combine operand, 3-input LOP3s and
// PLOP3s, one placement), ~0.027 ms at the H100's 16.7e12 INT32 lane
// operations a second, against ~0.012 ms for the 41 MB of bool output
// at 3.35 TB/s. What a design must avoid is everything else:
// loads, address arithmetic and stores per element. So:
//   - one thread owns FILTER_NODES_PER_THREAD (4) consecutive nodes and
//     loads their values once, folding every pod-independent term into
//     registers: node_ok = valid & static_mask & (pod_count < pod_cap),
//     res_gate = !exceed_cpu & !exceed_mem, free_cpu / free_mem =
//     cap - used, and the label (inverted), port and disk words;
//   - a block of FILTER_BLOCK_THREADS threads (512 nodes) walks a tile
//     of FILTER_POD_TILE (64) pods, staged once in shared memory (the
//     pod's scalars as one 16-byte record, then its bitset words), which
//     every warp reads as broadcasts. Node loads are paid once per 64
//     pods; 8192 pods are 128 tiles, x 10 node groups = 1280 blocks;
//   - per pod a thread packs its 4 fits into one uint32 and stores it: a
//     warp writes 128 contiguous bytes of the row. Row p starts at byte
//     p * N, so a row whose start is not 4-byte aligned (N odd or 2 mod
//     4) stores 2 or 1 bytes at a time, and the ragged tail byte by byte;
//   - the bitset widths are a template argument: W > 0 takes every set of
//     at most W words, held in registers (zero words past a set's width
//     match nothing); W == 0 takes any width and reads the words from
//     global memory (L1) in the pod loop.
//
// cap == 0 means "unlimited" (cc == 0 || cc - used >= req). free_cpu
// holds INT32_MAX for it, which is exact: INT32_MAX >= req for every
// int32 req. cap - used wraps in int32 as the plain version's does.
// Bitsets arrive as int32 views of uint32 words and are read as uint32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; filter_masks_launch is the plain-C entry point that
// kubernetes_tpu_torch/sched/device/filter_kernel.py calls through ctypes,
// with the instantiation and grid it picks (filter_kernel.launch_plan).

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#define FILTER_BLOCK_THREADS 128
#define FILTER_NODES_PER_THREAD 4
#define FILTER_POD_TILE 64

#define POD_VALID 1u
#define POD_ZERO_REQ 2u
#define POD_UNPINNED 4u

struct FilterParams {
  int P, N, LW, PW, KW;
  // node axis [N] / [N, W]
  const uint8_t* valid;
  const int32_t* cpu_cap;
  const int32_t* mem_cap;
  const int32_t* pod_cap;
  const uint8_t* exceed_cpu;
  const uint8_t* exceed_mem;
  const uint8_t* static_mask;
  const uint32_t* labels;
  const int32_t* cpu_used;
  const int32_t* mem_used;
  const int32_t* pod_count;
  const uint32_t* port_bits;
  const uint32_t* disk_any;
  const uint32_t* disk_rw;
  // pod axis [P] / [P, W]
  const uint8_t* pvalid;
  const int32_t* preq_cpu;
  const int32_t* preq_mem;
  const uint8_t* pzero;
  const uint32_t* psel;
  const uint32_t* pports;
  const uint32_t* pqany;
  const uint32_t* pqrw;
  const int32_t* phost;
  uint8_t* out;
};

struct __align__(16) PodScalars {
  int32_t req_cpu, req_mem, host;
  uint32_t flags;  // POD_VALID | POD_ZERO_REQ | POD_UNPINNED
};

__device__ __forceinline__ uint32_t word_or_zero(const uint32_t* row, int w,
                                                 int width) {
  return w < width ? row[w] : 0u;
}

// the packed fits of one pod: byte k is node n0 + k
__device__ __forceinline__ void store_fits(uint8_t* dst, uint32_t packed,
                                           int valid_nodes) {
  const uintptr_t align = (uintptr_t)dst & 3;
  if (valid_nodes == FILTER_NODES_PER_THREAD && align == 0) {
    *reinterpret_cast<uint32_t*>(dst) = packed;
  } else if (valid_nodes == FILTER_NODES_PER_THREAD && align == 2) {
    reinterpret_cast<uint16_t*>(dst)[0] = (uint16_t)packed;
    reinterpret_cast<uint16_t*>(dst)[1] = (uint16_t)(packed >> 16);
  } else {
    for (int k = 0; k < valid_nodes; ++k) dst[k] = (uint8_t)(packed >> (8 * k));
  }
}

template <int W>
__global__ void __launch_bounds__(FILTER_BLOCK_THREADS)
filter_kernel(const FilterParams a) {
  constexpr int NPT = FILTER_NODES_PER_THREAD;
  constexpr int PW_WORDS = W > 0 ? 4 * W : 1;  // sel, ports, qany, qrw
  __shared__ PodScalars pods[FILTER_POD_TILE];
  __shared__ __align__(16) uint32_t pod_words[FILTER_POD_TILE][PW_WORDS];

  // pod-independent terms of this thread's nodes, loaded before the pod
  // tile so that the two loads' latencies overlap (at P = 1, the
  // extender's launch, they are most of the kernel's time)
  const int n0 = (blockIdx.x * blockDim.x + threadIdx.x) * NPT;
  uint32_t node_ok[NPT], res_gate[NPT];
  int32_t free_cpu[NPT], free_mem[NPT];
  uint32_t nlab[NPT][W > 0 ? W : 1], port[NPT][W > 0 ? W : 1];
  uint32_t dany[NPT][W > 0 ? W : 1], drw[NPT][W > 0 ? W : 1];
#pragma unroll
  for (int k = 0; k < NPT; ++k) {
    const int n = n0 + k;
    node_ok[k] = 0u;
    res_gate[k] = 0u;
    free_cpu[k] = free_mem[k] = 0;
    if (n < a.N) {
      // & rather than &&: every load is issued at once, none waits on
      // another's value
      node_ok[k] = (a.valid[n] != 0) & (a.static_mask[n] != 0) &
                   (a.pod_count[n] < a.pod_cap[n]);
      res_gate[k] = (a.exceed_cpu[n] == 0) & (a.exceed_mem[n] == 0);
      const int32_t cc = a.cpu_cap[n], cm = a.mem_cap[n];
      free_cpu[k] = cc == 0 ? INT_MAX
          : (int32_t)((uint32_t)cc - (uint32_t)a.cpu_used[n]);
      free_mem[k] = cm == 0 ? INT_MAX
          : (int32_t)((uint32_t)cm - (uint32_t)a.mem_used[n]);
    }
    if constexpr (W > 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const bool in = n < a.N;
        nlab[k][w] = in ? ~word_or_zero(a.labels + (size_t)n * a.LW, w, a.LW)
                        : 0u;
        port[k][w] =
            in ? word_or_zero(a.port_bits + (size_t)n * a.PW, w, a.PW) : 0u;
        dany[k][w] =
            in ? word_or_zero(a.disk_any + (size_t)n * a.KW, w, a.KW) : 0u;
        drw[k][w] =
            in ? word_or_zero(a.disk_rw + (size_t)n * a.KW, w, a.KW) : 0u;
      }
    }
  }

  const int pod0 = blockIdx.y * FILTER_POD_TILE;
  const int tile = min(FILTER_POD_TILE, a.P - pod0);
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int p = pod0 + i;
    const int32_t host = a.phost[p];
    pods[i] = PodScalars{a.preq_cpu[p], a.preq_mem[p], host,
                         (a.pvalid[p] ? POD_VALID : 0u) |
                         (a.pzero[p] ? POD_ZERO_REQ : 0u) |
                         (host == -1 ? POD_UNPINNED : 0u)};
    if constexpr (W > 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        pod_words[i][w] = word_or_zero(a.psel + (size_t)p * a.LW, w, a.LW);
        pod_words[i][W + w] =
            word_or_zero(a.pports + (size_t)p * a.PW, w, a.PW);
        pod_words[i][2 * W + w] =
            word_or_zero(a.pqany + (size_t)p * a.KW, w, a.KW);
        pod_words[i][3 * W + w] =
            word_or_zero(a.pqrw + (size_t)p * a.KW, w, a.KW);
      }
    }
  }
  __syncthreads();
  if (n0 >= a.N) return;
  const int valid_nodes = min(NPT, a.N - n0);

  for (int i = 0; i < tile; ++i) {
    const int p = pod0 + i;
    const PodScalars ps = pods[i];
    const uint32_t zero = (ps.flags & POD_ZERO_REQ) ? 1u : 0u;
    const uint32_t pod_ok = (ps.flags & POD_VALID) ? 1u : 0u;
    const bool unpinned = ps.flags & POD_UNPINNED;
    uint32_t packed = 0u;
#pragma unroll
    for (int k = 0; k < NPT; ++k) {
      // PodFitsResources (predicates.go:192-222); pod count in node_ok
      const uint32_t res =
          ((free_cpu[k] >= ps.req_cpu) & (free_mem[k] >= ps.req_mem) &
           res_gate[k]) | zero;
      // PodFitsHostPorts, MatchNodeSelector, NoDiskConflict
      // (predicates.go:403-415, :250, :127-137) as one word test
      uint32_t acc = 0u;
      if constexpr (W > 0) {
#pragma unroll
        for (int w = 0; w < W; ++w)
          acc |= (pod_words[i][w] & nlab[k][w]) |
                 (pod_words[i][W + w] & port[k][w]) |
                 (pod_words[i][2 * W + w] & dany[k][w]) |
                 (pod_words[i][3 * W + w] & drw[k][w]);
      } else {
        const size_t n = (size_t)(n0 + k);
        if (n0 + k < a.N) {
          for (int w = 0; w < a.LW; ++w)
            acc |= a.psel[(size_t)p * a.LW + w] & ~a.labels[n * a.LW + w];
          for (int w = 0; w < a.PW; ++w)
            acc |= a.pports[(size_t)p * a.PW + w] & a.port_bits[n * a.PW + w];
          for (int w = 0; w < a.KW; ++w)
            acc |= (a.pqany[(size_t)p * a.KW + w] & a.disk_any[n * a.KW + w]) |
                   (a.pqrw[(size_t)p * a.KW + w] & a.disk_rw[n * a.KW + w]);
        }
      }
      // PodFitsHost (predicates.go:258)
      const uint32_t host_ok = (unpinned || ps.host == n0 + k) ? 1u : 0u;
      const uint32_t fit =
          node_ok[k] & pod_ok & res & host_ok & (acc == 0u ? 1u : 0u);
      packed |= fit << (8 * k);
    }
    store_fits(a.out + (size_t)p * a.N + n0, packed, valid_nodes);
  }
}

// words: the template's bitset width (1 or 2), or 0 for any width; grid
// as filter_kernel.launch_plan computes it. -> the CUDA error code.
extern "C" int filter_masks_launch(
    int words, int grid_x, int grid_y, int P, int N, int LW, int PW, int KW,
    const void* valid, const void* cpu_cap, const void* mem_cap,
    const void* pod_cap, const void* exceed_cpu, const void* exceed_mem,
    const void* static_mask, const void* labels, const void* cpu_used,
    const void* mem_used, const void* pod_count, const void* port_bits,
    const void* disk_any, const void* disk_rw, const void* pvalid,
    const void* preq_cpu, const void* preq_mem, const void* pzero,
    const void* psel, const void* pports, const void* pqany,
    const void* pqrw, const void* phost, void* out, void* stream) {
  const FilterParams a = {
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
      (uint8_t*)out};
  const dim3 grid(grid_x, grid_y);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (words) {
    case 1: filter_kernel<1><<<grid, FILTER_BLOCK_THREADS, 0, s>>>(a); break;
    case 2: filter_kernel<2><<<grid, FILTER_BLOCK_THREADS, 0, s>>>(a); break;
    case 0: filter_kernel<0><<<grid, FILTER_BLOCK_THREADS, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* filter_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
