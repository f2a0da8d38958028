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
// Design. A group of G lanes a node (G the power of two at or above V,
// 32 at most), across the victim axis: lane i loads victim i's
// priority, cpu, memory and valid flag, and every lane of the group the
// node's own fields (one address a field: one transaction), so a row is
// one round trip of independent loads, not up to V + 1 dependent ones.
// The masked cpu and memory go through an inclusive warp scan
// (__shfl_up_sync within the group), which gives lane i the release of
// the first i + 1 victims; res_ok for every k = i + 1 is one
// __ballot_sync, and nv one __popc of the mask's ballot. The first k
// with res_ok is the first feasible k when k <= nv, and no k is
// feasible otherwise (a feasible k would be an earlier res_ok), so k*
// is the first set bit (__ffs) of the ballot, or 0 when k = 0 already
// fits; the senior victim is a shuffle from lane k* - 1. V > 32 walks
// chunks of 32, carrying the prefix sums and nv, and stops once every
// node of the warp has its first res_ok and enough evictable victims to
// reach it.
// Then the first maximum (the larger score, then the smaller index):
// redux.sync and shared memory within a block, and across blocks the
// last block to finish: the grid gives every group one node, at most
// one CTA an SM where the nodes allow it (the SMs share the work
// evenly); each block's winner goes to a scratch array and is counted
// on an atomic counter (release / acquire at device scope, before the
// block writes its nodes' kstar and score, so the release waits on no
// node's write), and the last block reduces the winners and writes
// pick, in the same launch, and sets the counter back to 0 for the next
// launch (the wrapper keeps one counter a device, zeroed once). A
// cluster of up to 16 CTAs reducing over distributed shared memory
// instead was 3x slower at 5120 x 16 (its groups walk the nodes in
// passes) and no faster at 5120 x 1 (PERF.md section 6).
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

#define VICTIM_BLOCK_THREADS 1024

// sched/preemption.py
#define PMAX 1000000000LL
#define SENIOR_NONE (-PMAX - 1)
#define SCORE_STRIDE (2 * PMAX + 2)

struct VictimParams {
  int N, V, G;
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
  int64_t* pick;          // [1]
  int64_t* kstar;         // [N]
  int64_t* score;         // [N]
  int64_t* block_score;   // [gridDim.x] scratch
  int64_t* block_index;   // [gridDim.x] scratch
  unsigned int* done;     // [1], zero before the launch and after it
  // the sharded search: shards, rows a shard, the shards' winners
  int shards, B;
  int64_t* shard_score;   // [shards] scratch
  int64_t* shard_index;   // [shards] scratch
};

// int64 addition that wraps as the tensors' does
__device__ __forceinline__ int64_t wadd(int64_t a, int64_t b) {
  return (int64_t)((uint64_t)a + (uint64_t)b);
}

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

// the warp's best (s, i) in every lane, as beats() orders them, by
// redux.sync: the score's signed high word, then its unsigned low word
// among the lanes holding that high word, then the smallest index among
// the lanes holding the score
__device__ __forceinline__ void warp_best(int64_t& s, int& i) {
  const int hi = __reduce_max_sync(0xffffffffu, (int)(s >> 32));
  const unsigned lo = __reduce_max_sync(
      0xffffffffu, (int)(s >> 32) == hi ? (unsigned)s : 0u);
  const int64_t m =
      (int64_t)(((uint64_t)(uint32_t)hi << 32) | (uint64_t)lo);
  i = (int)__reduce_min_sync(0xffffffffu,
                             (unsigned)(s == m ? i : INT_MAX));
  s = m;
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

// node j's search by its group of G lanes (g = this lane's place in it,
// base = the group's first lane in the warp); every lane of the warp
// calls it together, `act` false for a group past the last node. ->
// (kstar, score) in every lane of the group.
__device__ __forceinline__ void search_node(const VictimParams& a, int j,
                                            bool act, int g, int base,
                                            int64_t& ks, int64_t& sc) {
  const int G = a.G;
  // every load of the node and of its first chunk is issued at once: none
  // waits on the candidate flag
  bool cand = false;
  int64_t pc = 0, pcap = 0, cc = 0, mc = 0, cu = 0, mu = 0, tie = 0;
  if (act) {
    cand = a.cand[j];
    pc = a.pod_count[j]; pcap = a.pod_cap[j];
    cc = a.cpu_cap[j]; mc = a.mem_cap[j];
    cu = a.cpu_used[j]; mu = a.mem_used[j];
    tie = a.tie_rank[j];
  }
  // k0: the first k with res_ok (-1: none yet); k = 0 before any chunk
  int k0 = cand && fits_after(a, pc, pcap, cc, mc, cu, mu, 0, 0, 0) ? 0 : -1;
  int64_t senior = SENIOR_NONE, rc0 = 0, rm0 = 0;
  int nv = 0;
  const size_t row = (size_t)j * a.V;
  for (int c0 = 0; c0 < a.V; c0 += G) {
    const int i = c0 + g;
    const bool has = act && i < a.V;
    int64_t vp = 0, vc = 0, vm = 0;
    bool valid = false;
    if (has) {
      vp = a.v_prio[row + i];
      vc = a.v_cpu[row + i];
      vm = a.v_mem[row + i];
      valid = a.v_valid[row + i];
    }
    const bool m = cand && has && valid && vp < a.prio;
    int64_t rc = m ? vc : 0, rm = m ? vm : 0;
    // inclusive scan over the group: lane g holds victims c0 .. c0 + g
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      if (d >= G) break;
      const int64_t tc = __shfl_up_sync(0xffffffffu, rc, d, G);
      const int64_t tm = __shfl_up_sync(0xffffffffu, rm, d, G);
      if (g >= d) { rc = wadd(rc, tc); rm = wadd(rm, tm); }
    }
    rc = wadd(rc, rc0);
    rm = wadd(rm, rm0);
    const bool ok = cand && has && fits_after(a, pc, pcap, cc, mc, cu, mu,
                                              i + 1, rc, rm);
    const unsigned gm = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << base;
    const unsigned okb = (__ballot_sync(0xffffffffu, ok) & gm) >> base;
    const unsigned mb = (__ballot_sync(0xffffffffu, m) & gm) >> base;
    const int f = __ffs(okb) - 1;                 // -1: no bit set
    const int64_t sv = __shfl_sync(0xffffffffu, vp, base + (f > 0 ? f : 0));
    if (k0 < 0 && f >= 0) {
      k0 = c0 + f + 1;
      senior = sv;
    }
    nv += __popc(mb);
    rc0 = __shfl_sync(0xffffffffu, rc, base + G - 1);
    rm0 = __shfl_sync(0xffffffffu, rm, base + G - 1);
    // on past this chunk only while a node of the warp has no fitting k
    // yet, or too few evictable victims to reach it
    if (!__any_sync(0xffffffffu, cand && c0 + G < a.V
                                      && !(k0 >= 0 && k0 <= nv)))
      break;
  }
  ks = 0;
  sc = -1;
  if (cand && k0 >= 0 && k0 <= nv) {
    ks = k0;
    sc = (((int64_t)a.V - k0) * SCORE_STRIDE + (PMAX - senior))
             * (int64_t)a.N + tie;
  }
}

__global__ void __launch_bounds__(VICTIM_BLOCK_THREADS)
victim_kernel(const VictimParams a) {
  const int G = a.G;
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1), base = lane & ~(G - 1);
  // the group's node: the grid covers every node once
  const int j = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5)
                    * (32 / G) + base / G;
  const bool act = j < a.N;
  int64_t ks, sc;
  search_node(a, j, act, g, base, ks, sc);
  // threads past N never win, not even against an all -1 fleet
  int64_t best = LLONG_MIN;
  int best_j = INT_MAX;
  if (act && g == 0) { best = sc; best_j = j; }
  block_best(best, best_j);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    a.block_score[blockIdx.x] = best;
    a.block_index[blockIdx.x] = best_j;
    // count this block done, releasing its record; the last block
    // acquires every other block's
    unsigned prev;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
                 : "=r"(prev) : "l"(a.done) : "memory");
    last = prev == gridDim.x - 1;
  }
  if (act && g == 0) {    // after the count: its release orders none
    a.kstar[j] = ks;
    a.score[j] = sc;
  }
  __syncthreads();
  if (!last) return;
  best = LLONG_MIN;
  best_j = INT_MAX;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += blockDim.x) {
    const int64_t s = __ldcg(a.block_score + b);
    const int i = (int)__ldcg(a.block_index + b);
    if (beats(s, i, best, best_j)) { best = s; best_j = i; }
  }
  block_best(best, best_j);
  if (threadIdx.x == 0) {
    a.pick[0] = best_j;
    *a.done = 0;     // ready for the next launch (a graph replays it)
  }
}

// The sharded search (K4 over a node-axis mesh, the JAX engine's
// find_victims under a mesh: kstar and score split by row, pick
// reduced across the shards): the grid is `shards` runs of the same
// number of blocks, run k over the rows [k * B, min(N, (k + 1) * B)).
// Each block posts its winner as above; the last block of a shard to
// finish (its own counter, done[1 + k]) reduces the shard's blocks and
// posts the shard's winner, and the last shard to finish (done[0])
// reduces the shards' winners (K7) and writes pick. Every counter is
// set back to 0 by the block that read it last.
__device__ __forceinline__ bool count_done(unsigned int* counter,
                                           unsigned int total) {
  unsigned prev;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(prev) : "l"(counter) : "memory");
  return prev == total - 1;
}

__global__ void __launch_bounds__(VICTIM_BLOCK_THREADS)
victim_sharded_kernel(const VictimParams a) {
  const int G = a.G;
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1), base = lane & ~(G - 1);
  const int per = (int)gridDim.x / a.shards;
  const int shard = (int)blockIdx.x / per, local = (int)blockIdx.x % per;
  const int lo = shard * a.B;
  const int hi = min(a.N, lo + a.B);
  const int j = lo + (int)((local * blockDim.x + threadIdx.x) >> 5)
                         * (32 / G) + base / G;
  const bool act = j < hi;
  int64_t ks, sc;
  search_node(a, j, act, g, base, ks, sc);
  __shared__ bool last;
  int64_t best = LLONG_MIN;
  int best_j = INT_MAX;
  if (act && g == 0) { best = sc; best_j = j; }
  block_best(best, best_j);
  if (threadIdx.x == 0) {
    a.block_score[blockIdx.x] = best;
    a.block_index[blockIdx.x] = best_j;
    last = count_done(a.done + 1 + shard, per);
  }
  if (act && g == 0) {    // after the count: its release orders none
    a.kstar[j] = ks;
    a.score[j] = sc;
  }
  __syncthreads();
  if (!last) return;
  // the shard's winner over its blocks
  best = LLONG_MIN;
  best_j = INT_MAX;
  for (int b = threadIdx.x; b < per; b += blockDim.x) {
    const int64_t s = __ldcg(a.block_score + shard * per + b);
    const int i = (int)__ldcg(a.block_index + shard * per + b);
    if (beats(s, i, best, best_j)) { best = s; best_j = i; }
  }
  block_best(best, best_j);
  __syncthreads();
  if (threadIdx.x == 0) {
    a.done[1 + shard] = 0;
    a.shard_score[shard] = best;
    a.shard_index[shard] = best_j;
    last = count_done(a.done, a.shards);
  }
  __syncthreads();
  if (!last) return;
  // the mesh's winner over the shards' (K7)
  best = LLONG_MIN;
  best_j = INT_MAX;
  for (int r = threadIdx.x; r < a.shards; r += blockDim.x) {
    const int64_t s = __ldcg(a.shard_score + r);
    const int i = (int)__ldcg(a.shard_index + r);
    if (beats(s, i, best, best_j)) { best = s; best_j = i; }
  }
  block_best(best, best_j);
  if (threadIdx.x == 0) {
    a.done[0] = 0;
    a.pick[0] = best_j;
  }
}

// the sharded search: `shards` runs of grid / shards blocks, `B` rows a
// shard (the last may hold fewer); the output buffer as
// victim_search_launch's, then shard_score and shard_index [shards];
// `done` holds 1 + shards counters
extern "C" int victim_sharded_launch(
    int grid, int threads, int group, int shards, int B, int N, int V,
    const void* cand, const void* cpu_cap, const void* mem_cap,
    const void* pod_cap, const void* cpu_used, const void* mem_used,
    const void* pod_count, const void* tie_rank, const void* v_prio,
    const void* v_cpu, const void* v_mem, const void* v_valid,
    long long prio, long long req_cpu, long long req_mem, int zero_req,
    void* out, void* done, void* stream) {
  if (N <= 0 || V < 0 || grid <= 0 || shards < 1 || grid % shards != 0
      || B < 1 || (long long)B * shards < N || group < 1 || group > 32
      || (group & (group - 1)) != 0
      || (long long)(grid / shards) * threads < (long long)B * group)
    return (int)cudaErrorInvalidValue;
  int64_t* o = (int64_t*)out;
  int64_t* blocks = o + 1 + 2 * (size_t)N;
  VictimParams a = {
      N, V, group, (const uint8_t*)cand, (const int64_t*)cpu_cap,
      (const int64_t*)mem_cap, (const int64_t*)pod_cap,
      (const int64_t*)cpu_used, (const int64_t*)mem_used,
      (const int64_t*)pod_count, (const int64_t*)tie_rank,
      (const int64_t*)v_prio, (const int64_t*)v_cpu, (const int64_t*)v_mem,
      (const uint8_t*)v_valid, (int64_t)prio, (int64_t)req_cpu,
      (int64_t)req_mem, zero_req, o, o + 1, o + 1 + N, blocks,
      blocks + grid, (unsigned int*)done};
  a.shards = shards;
  a.B = B;
  a.shard_score = blocks + 2 * (size_t)grid;
  a.shard_index = a.shard_score + shards;
  victim_sharded_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// group: lanes a node (a power of two, 1..32); the grid's groups must
// cover the N nodes. The outputs and scratch are one int64 buffer:
// pick, kstar [N], score [N], block_score and block_index [grid].
extern "C" int victim_search_launch(
    int grid, int threads, int group, int N, int V, const void* cand,
    const void* cpu_cap, const void* mem_cap, const void* pod_cap,
    const void* cpu_used, const void* mem_used, const void* pod_count,
    const void* tie_rank, const void* v_prio, const void* v_cpu,
    const void* v_mem, const void* v_valid, long long prio,
    long long req_cpu, long long req_mem, int zero_req, void* out,
    void* done, void* stream) {
  if (N <= 0 || V < 0 || grid <= 0 || group < 1 || group > 32
      || (group & (group - 1)) != 0
      || (long long)grid * threads < (long long)N * group)
    return (int)cudaErrorInvalidValue;
  int64_t* o = (int64_t*)out;
  const VictimParams a = {
      N, V, group, (const uint8_t*)cand, (const int64_t*)cpu_cap,
      (const int64_t*)mem_cap, (const int64_t*)pod_cap,
      (const int64_t*)cpu_used, (const int64_t*)mem_used,
      (const int64_t*)pod_count, (const int64_t*)tie_rank,
      (const int64_t*)v_prio, (const int64_t*)v_cpu, (const int64_t*)v_mem,
      (const uint8_t*)v_valid, (int64_t)prio, (int64_t)req_cpu,
      (int64_t)req_mem, zero_req, o, o + 1, o + 1 + N, o + 1 + 2 * (size_t)N,
      o + 1 + 2 * (size_t)N + grid, (unsigned int*)done,
      0, 0, nullptr, nullptr};
  victim_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* victim_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
