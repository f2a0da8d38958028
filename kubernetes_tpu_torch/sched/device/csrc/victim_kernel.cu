// The preemption victim-search kernel for Hopper (sm_90a).
//
// Replaces the XLA program of the JAX engine's victim search
// (kubernetes_tpu/sched/device/engine.py, _make_preempt, run by
// BatchEngine.find_victims). For one preemptor (priority prio, request
// req_cpu / req_mem, zero_req when it requests nothing) over N nodes,
// each with up to V victims sorted (priority asc, insertion asc):
//
//   vm[j, i]  = v_valid[j, i] && v_prio[j, i] < prio, nv[j] = sum_i vm
//   rc[j, k]  = sum_{i < k} (vm ? v_cpu : 0), rm likewise   (k = 0..V)
//   res_ok    = (pod_count - k < pod_cap) && (zero_req ||
//               ((cpu_cap == 0 || cpu_cap - (cpu_used - rc) >= req_cpu)
//                && (mem_cap == 0 || mem_cap - (mem_used - rm) >= req_mem)))
//   feas[j,k] = cand[j] && k <= nv[j] && res_ok
//   kstar[j]  = the first feasible k (0 when none is)
//   score[j]  = ((V - kstar) * SCORE_STRIDE + (PMAX - senior)) * N
//               + tie_rank   (senior = v_prio[j, kstar - 1], or
//               SENIOR_NONE at kstar 0), -1 where no k is feasible
//   pick      = the first index of the largest score (np.argmax)
//
// every term in int64, as sched/preemption.py's oracle computes it.
//
// Design: one thread a node walks its victim row in order, as the
// serial oracle does (oracle_find_victims), and stops at the first k
// whose release fits: the first k with res_ok is the first feasible k
// when k <= nv, and no k is feasible otherwise (any feasible k would be
// an earlier res_ok). Only when the prefix seen so far holds a masked
// entry (never, for the encoder's sorted victim tables) does it count
// the rest of the row for nv. A thread's row is a cache line a matrix
// at V = 16, so its successive reads hit L1. (Loading 8 victims at
// once before walking them took the kernel from 36 to 106 registers
// and was no faster on the H100.)
// Then the first maximum: warp shuffles and shared memory within a
// block, each block's winner to a scratch array, and the last block to
// finish (an atomic counter after a __threadfence) reduces those and
// writes pick, in the same launch, and sets the counter back to 0 for
// the next launch (the wrapper keeps one counter a device, zeroed once:
// no memset rides along with each launch).
//
// Bound: bytes. At N = 5000, V = 16 the inputs are ~2.3 MB (three
// int64 victim matrices) and the function does a few int64 operations
// a victim walked, ~0.7 us at 3.35 TB/s: below one launch, so the
// kernel is read against the launch floor.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; victim_search_launch is the plain-C entry point that
// kubernetes_tpu_torch/sched/device/victim_kernel.py calls through
// ctypes.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define VICTIM_BLOCK_THREADS 256

// sched/preemption.py
#define PMAX 1000000000LL
#define SENIOR_NONE (-PMAX - 1)
#define SCORE_STRIDE (2 * PMAX + 2)

struct VictimParams {
  int N, V;
  const uint8_t* cand;
  const int64_t* cpu_cap;
  const int64_t* mem_cap;
  const int64_t* pod_cap;
  const int64_t* cpu_used;
  const int64_t* mem_used;
  const int64_t* pod_count;
  const int64_t* tie_rank;
  const int64_t* v_prio;
  const int64_t* v_cpu;
  const int64_t* v_mem;
  const uint8_t* v_valid;
  int64_t prio, req_cpu, req_mem;
  int zero_req;
  int64_t* kstar;         // [N]
  int64_t* score;         // [N]
  int64_t* pick;          // [1]
  int64_t* block_score;   // [gridDim.x] scratch
  int* block_index;       // [gridDim.x] scratch
  unsigned int* done;     // [1], zero before the launch and after it
};

// does the preemptor fit once the first k victims (releasing rc cpu and
// rm memory) are gone? The engine's predicate forms: the pod count, and
// unless the preemptor requests nothing, cpu and memory with a zero
// capacity as unlimited
__device__ __forceinline__ bool fits_after(const VictimParams& a,
                                           int64_t pc, int64_t pcap,
                                           int64_t cc, int64_t mc,
                                           int64_t cu, int64_t mu, int k,
                                           int64_t rc, int64_t rm) {
  const bool fits = pc - k < pcap;
  if (a.zero_req) return fits;
  return fits && (cc == 0 || cc - (cu - rc) >= a.req_cpu)
              && (mc == 0 || mc - (mu - rm) >= a.req_mem);
}

// (s, i) beats (t, j): the larger score, then the smaller index
__device__ __forceinline__ bool beats(int64_t s, int i, int64_t t, int j) {
  return s > t || (s == t && i < j);
}

__device__ __forceinline__ void warp_best(int64_t& s, int& i) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const int64_t t = __shfl_xor_sync(0xffffffffu, s, m);
    const int j = __shfl_xor_sync(0xffffffffu, i, m);
    if (beats(t, j, s, i)) { s = t; i = j; }
  }
}

// the block's first maximum, returned to every thread
__device__ void block_best(int64_t& s, int& i) {
  __shared__ int64_t ws[VICTIM_BLOCK_THREADS / 32];
  __shared__ int wi[VICTIM_BLOCK_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_best(s, i);
  if (lane == 0) { ws[warp] = s; wi[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    s = lane < (int)(blockDim.x >> 5) ? ws[lane] : LLONG_MIN;
    i = lane < (int)(blockDim.x >> 5) ? wi[lane] : INT_MAX;
    warp_best(s, i);
    if (lane == 0) { ws[0] = s; wi[0] = i; }
  }
  __syncthreads();
  s = ws[0];
  i = wi[0];
}

__global__ void __launch_bounds__(VICTIM_BLOCK_THREADS)
victim_kernel(const VictimParams a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  // threads past N never win, not even against an all -1 fleet
  int64_t best = LLONG_MIN;
  int best_j = INT_MAX;
  if (j < a.N) {
    int64_t ks = 0, sc = -1;
    if (a.cand[j]) {
      const size_t row = (size_t)j * a.V;
      const int64_t* vp = a.v_prio + row;
      const int64_t* vc = a.v_cpu + row;
      const int64_t* vmm = a.v_mem + row;
      const uint8_t* vv = a.v_valid + row;
      const int64_t pc = a.pod_count[j], pcap = a.pod_cap[j];
      const int64_t cc = a.cpu_cap[j], mc = a.mem_cap[j];
      const int64_t cu = a.cpu_used[j], mu = a.mem_used[j];
      const int64_t tie_rank = a.tie_rank[j];    // loaded with the rest
      int64_t rc = 0, rm = 0, nv = 0;
      int k = 0;
      bool ok = fits_after(a, pc, pcap, cc, mc, cu, mu, 0, 0, 0);
      while (!ok && k < a.V) {
        if (vv[k] && vp[k] < a.prio) {
          rc += vc[k];
          rm += vmm[k];
          ++nv;
        }
        ++k;
        ok = fits_after(a, pc, pcap, cc, mc, cu, mu, k, rc, rm);
      }
      // nv so far counts the masked entries before k; the rest of the
      // row only matters when that falls short of k
      for (int i = k; nv < k && i < a.V; ++i)
        nv += (vv[i] && vp[i] < a.prio) ? 1 : 0;
      if (ok && k <= nv) {
        ks = k;
        const int64_t senior = k > 0 ? vp[k - 1] : SENIOR_NONE;
        sc = (((int64_t)a.V - k) * SCORE_STRIDE + (PMAX - senior))
                 * (int64_t)a.N + tie_rank;
      }
    }
    a.kstar[j] = ks;
    a.score[j] = sc;
    best = sc;
    best_j = j;
  }
  block_best(best, best_j);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    a.block_score[blockIdx.x] = best;
    a.block_index[blockIdx.x] = best_j;
    __threadfence();
    last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  best = LLONG_MIN;
  best_j = INT_MAX;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
    const int64_t s = __ldcg(a.block_score + b);
    const int i = __ldcg(a.block_index + b);
    if (beats(s, i, best, best_j)) { best = s; best_j = i; }
  }
  block_best(best, best_j);
  if (threadIdx.x == 0) {
    a.pick[0] = best_j;
    *a.done = 0;     // ready for the next launch (a graph replays it)
  }
}

extern "C" int victim_search_launch(
    int grid, int threads, int N, int V, const void* cand,
    const void* cpu_cap, const void* mem_cap, const void* pod_cap,
    const void* cpu_used, const void* mem_used, const void* pod_count,
    const void* tie_rank, const void* v_prio, const void* v_cpu,
    const void* v_mem, const void* v_valid, long long prio,
    long long req_cpu, long long req_mem, int zero_req, void* kstar,
    void* score, void* pick, void* block_score, void* block_index,
    void* done, void* stream) {
  if (N <= 0 || V < 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  const VictimParams a = {
      N, V, (const uint8_t*)cand, (const int64_t*)cpu_cap,
      (const int64_t*)mem_cap, (const int64_t*)pod_cap,
      (const int64_t*)cpu_used, (const int64_t*)mem_used,
      (const int64_t*)pod_count, (const int64_t*)tie_rank,
      (const int64_t*)v_prio, (const int64_t*)v_cpu, (const int64_t*)v_mem,
      (const uint8_t*)v_valid, (int64_t)prio, (int64_t)req_cpu,
      (int64_t)req_mem, zero_req, (int64_t*)kstar, (int64_t*)score,
      (int64_t*)pick, (int64_t*)block_score, (int*)block_index,
      (unsigned int*)done};
  victim_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* victim_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
