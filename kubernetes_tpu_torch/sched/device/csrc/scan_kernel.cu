// The scan step (K1) and the stateless probe (K5) for Hopper (sm_90a).
//
// K1 replaces the XLA program of the JAX engine's sequential pod loop
// (kubernetes_tpu/sched/device/engine.py: _make_run's lax.scan over
// _step, which runs _mask_and_score, _commit_node_local and
// _aff_count_update). For each pod of a chunk, in order:
//
//   mask[n]   = the predicates (pod count, cpu / memory with cap == 0 as
//               unlimited and the zero-request bypass, host ports, node
//               selector, host name, disks, the static mask; with
//               HAS_AFF the inter-pod affinity terms) against the State
//               as the earlier pods of the chunk left it
//   total[n]  = w0 * LeastRequested + w1 * Balanced + static_score
//               (+ w2 * SelectorSpread with HAS_SPREAD, + anti_weight *
//               ServiceAntiAffinity with ANTI)
//   pick      = argmax of total * N + tie_rank over the fitting slots
//               (injective: tie_rank is distinct per valid node), -1
//               when no slot fits
//   commit    = the pod's requests, count, ports, disks, spread, term
//               and service counts added into the State at pick
//
// K5 replaces _make_probe's vmap: every pod of the batch against the
// same, unchanged State, writing mask bool[P, N] and total T[P, N] (the
// spread tier always on: the extender returns absolute scores).
//
// Both run one __device__ body (fits / node_total / anti_score) that
// repeats engine._mask_and_score's arithmetic operation for operation,
// in the carried integer type T (int32 when the encoder narrowed the
// resources, int64 otherwise). Integer arithmetic in T wraps as the
// tensors' does (wadd / wsub / wmul through the unsigned type). Every
// f64 formula is written with __dmul_rn / __dsub_rn / __ddiv_rn, which
// nvcc never contracts into an FMA: Balanced's 10 - diff * 10 fused into
// one DFMA drops the floor by one where diff * 10 is exactly an integer
// (cpu_frac 0.9, mem_frac 0), the fault of the JAX probe on the CPU.
// The exact floor division (_floordiv_exact) is repeated as it is: the
// f64 reciprocal-multiply estimate and its two integer corrections.
//
// Design. K1: one persistent block (SCAN_BLOCK_THREADS threads) walks
// the chunk's pods in order; its threads stride over the N node slots.
// Per pod: the pod's bitset words and affinity terms staged in shared
// memory; with a spread group, a block max of spread[gid, :]; with
// ANTI, a shared-memory histogram of svc_count[g, :] by zone under the
// pod's own mask (a first pass keeps mask and total in a global scratch
// row, a second adds the zone score); a block argmax on (composite,
// slot); the winner's commit into the State in place, spread over the
// threads by bitset word, group, term and service; __syncthreads()
// before the next pod. Invalid (padded) pods commit nothing. One SM does
// the whole chunk: the chain of pods is sequential, and a grid-wide
// barrier a pod costs more than the pod's work. Spreading the node axis
// over a thread-block cluster (distributed shared memory, a cluster
// barrier a pod) is the next design.
// K5: one block (PROBE_BLOCK_THREADS threads) a pod, the same body and
// per-pod reductions, no commit.
//
// Bound: operations (sched/device/bounds.py scan_ops / probe_ops): at
// 8192 pods x 5120 slots, ~70 INT32 and ~45 FP64 instructions an
// element, ~0.1-0.2 ms for the whole card; K1 runs on one SM of 132, so
// it sits two orders of magnitude above it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; scan_launch is the plain-C entry point that
// kubernetes_tpu_torch/sched/device/scan_kernel.py calls through ctypes,
// with the tensors' addresses in the order of enum ScanPtr and the sizes
// and weights in the order of enum ScanDim.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#define SCAN_BLOCK_THREADS 1024
#define PROBE_BLOCK_THREADS 512
#define SCAN_MAX_SHARED_BYTES 232448

// the addresses the wrapper packs (scan_kernel.PTR_FIELDS, same order)
enum ScanPtr {
  PTR_VALID, PTR_SCHED_OK, PTR_CPU_CAP, PTR_MEM_CAP, PTR_POD_CAP,
  PTR_LABELS, PTR_TIE_RANK, PTR_EXCEED_CPU, PTR_EXCEED_MEM,
  PTR_OFFGRID_MAX, PTR_AFF_DOM, PTR_ZONE_ID, PTR_STATIC_MASK,
  PTR_STATIC_SCORE, PTR_INV_CPU, PTR_INV_MEM,
  PTR_CPU_USED, PTR_MEM_USED, PTR_NZ_CPU, PTR_NZ_MEM, PTR_POD_COUNT,
  PTR_PORT_BITS, PTR_DISK_ANY, PTR_DISK_RW, PTR_SPREAD, PTR_AFF_COUNT,
  PTR_AFF_TOTAL, PTR_SVC_COUNT, PTR_SVC_TOTAL,
  PTR_POD_VALID, PTR_REQ_CPU, PTR_REQ_MEM, PTR_ZERO_REQ, PTR_POD_NZ_CPU,
  PTR_POD_NZ_MEM, PTR_SEL, PTR_PORTS, PTR_QANY, PTR_QRW, PTR_SANY,
  PTR_SRW, PTR_HOST_IDX, PTR_GROUP_ID, PTR_MEMBER, PTR_AFF_REQ,
  PTR_ANTI_REQ, PTR_AFF_MEMBER, PTR_SVC_GROUP, PTR_SVC_MEMBER,
  PTR_ASSIGNED, PTR_MASK, PTR_TOTAL, PTR_WORK_TOTAL, PTR_WORK_MASK,
  PTR_COUNT
};

// the sizes and weights the wrapper packs (scan_kernel.DIM_FIELDS)
enum ScanDim {
  DIM_P, DIM_N, DIM_L, DIM_PW, DIM_K, DIM_G, DIM_T, DIM_D, DIM_S, DIM_Z,
  DIM_W_LR, DIM_W_BAL, DIM_W_SPREAD, DIM_W_ANTI, DIM_COUNT
};

template <typename T>
struct Params {
  int P, N, L, PW, K, G, NT, D, S, Z;
  T w_lr, w_bal, w_spread, w_anti;
  // node tables (read only)
  const uint8_t* valid;
  const uint8_t* sched_ok;
  const T* cpu_cap;
  const T* mem_cap;
  const int* pod_cap;
  const uint32_t* labels;       // [N, L]
  const int* tie_rank;
  const uint8_t* exceed_cpu;
  const uint8_t* exceed_mem;
  const int* offgrid_max;       // [G]
  const int* aff_dom;           // [NT, N]
  const int* zone_id;
  const uint8_t* static_mask;
  const T* static_score;
  const double* inv_cpu;        // 1 / max(cpu_cap, 1)
  const double* inv_mem;
  // State (K1 commits into it; K5 only reads it)
  T* cpu_used;
  T* mem_used;
  T* nz_cpu;
  T* nz_mem;
  int* pod_count;
  uint32_t* port_bits;          // [N, PW]
  uint32_t* disk_any;           // [N, K]
  uint32_t* disk_rw;            // [N, K]
  int* spread;                  // [G, N]
  int* aff_count;               // [NT, D]
  int* aff_total;               // [NT]
  int* svc_count;               // [S, N]
  int* svc_total;               // [S]
  // pods
  const uint8_t* pod_valid;
  const T* req_cpu;
  const T* req_mem;
  const uint8_t* zero_req;
  const T* pod_nz_cpu;
  const T* pod_nz_mem;
  const uint32_t* sel;          // [P, L]
  const uint32_t* ports;        // [P, PW]
  const uint32_t* qany;         // [P, K]
  const uint32_t* qrw;
  const uint32_t* sany;
  const uint32_t* srw;
  const int* host_idx;
  const int* group_id;
  const int* member;            // [P, G]
  const uint8_t* aff_req;       // [P, NT]
  const uint8_t* anti_req;      // [P, NT]
  const int* aff_member;        // [P, NT]
  const int* svc_group;
  const int* svc_member;        // [P, S]
  // outputs and scratch
  int* assigned;                // K1 [P]
  uint8_t* mask;                // K5 [P, N]
  T* total;                     // K5 [P, N]
  T* work_total;                // K1 [N], ANTI only
  uint8_t* work_mask;           // K1 [N], ANTI only
};

// integer arithmetic in T that wraps as the tensors' does
template <typename T>
__device__ __forceinline__ T wadd(T a, T b) {
  using U = typename std::make_unsigned<T>::type;
  return (T)((U)a + (U)b);
}
template <typename T>
__device__ __forceinline__ T wsub(T a, T b) {
  using U = typename std::make_unsigned<T>::type;
  return (T)((U)a - (U)b);
}
template <typename T>
__device__ __forceinline__ T wmul(T a, T b) {
  using U = typename std::make_unsigned<T>::type;
  return (T)((U)a * (U)b);
}

// One pod's scalars, read by every thread, and its staged rows.
template <typename T>
struct Pod {
  int k;
  bool valid, zero_req;
  T req_cpu, req_mem, nz_cpu, nz_mem;
  int host_idx, group_id, gid, svc_group, svc_tot, maxc;
  const uint32_t* words;   // shared: sel [L], ports [PW], qany [K], qrw [K]
  const int* terms;        // shared: aff_req, anti_req, aff_member [NT]
  int* zones;              // shared: zone histogram [Z] (ANTI)
};

// Stage pod k: its scalars into registers, its bitset words and terms
// into shared memory, the zone histogram zeroed; ends with a barrier.
template <typename T, bool HAS_AFF, bool ANTI>
__device__ Pod<T> stage_pod(const Params<T>& a, int k, int* smem) {
  Pod<T> p;
  p.k = k;
  p.valid = a.pod_valid[k] != 0;
  p.zero_req = a.zero_req[k] != 0;
  p.req_cpu = a.req_cpu[k];
  p.req_mem = a.req_mem[k];
  p.nz_cpu = a.pod_nz_cpu[k];
  p.nz_mem = a.pod_nz_mem[k];
  p.host_idx = a.host_idx[k];
  p.group_id = a.group_id[k];
  p.gid = p.group_id > 0 ? p.group_id : 0;
  p.svc_group = a.svc_group[k];
  p.svc_tot = 0;
  if (ANTI && p.svc_group >= 0) p.svc_tot = a.svc_total[p.svc_group];
  p.maxc = 0;
  int* zones = smem;
  uint32_t* words = (uint32_t*)(smem + a.Z);
  int* terms = smem + a.Z + a.L + a.PW + 2 * a.K;
  const int nw = a.L + a.PW + 2 * a.K;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) {
    uint32_t w;
    if (i < a.L) w = a.sel[(size_t)k * a.L + i];
    else if (i < a.L + a.PW) w = a.ports[(size_t)k * a.PW + i - a.L];
    else if (i < a.L + a.PW + a.K)
      w = a.qany[(size_t)k * a.K + i - a.L - a.PW];
    else w = a.qrw[(size_t)k * a.K + i - a.L - a.PW - a.K];
    words[i] = w;
  }
  if (HAS_AFF) {
    for (int i = threadIdx.x; i < a.NT; i += blockDim.x) {
      const size_t r = (size_t)k * a.NT + i;
      terms[i] = a.aff_req[r];
      terms[a.NT + i] = a.anti_req[r];
      terms[2 * a.NT + i] = a.aff_member[r];
    }
  }
  if (ANTI)
    for (int i = threadIdx.x; i < a.Z; i += blockDim.x) zones[i] = 0;
  p.words = words;
  p.terms = terms;
  p.zones = zones;
  __syncthreads();
  return p;
}

// the predicate mask of pod p on slot n
template <typename T, bool HAS_AFF>
__device__ __forceinline__ bool fits(const Params<T>& a, const Pod<T>& p,
                                     int n) {
  if (!(p.valid && a.valid[n] && a.sched_ok[n] && a.static_mask[n]))
    return false;
  if (p.host_idx != -1 && p.host_idx != n) return false;
  if (!(a.pod_count[n] < a.pod_cap[n])) return false;
  if (!p.zero_req) {
    if (a.exceed_cpu[n] || a.exceed_mem[n]) return false;
    const T ccap = a.cpu_cap[n], mcap = a.mem_cap[n];
    if (ccap != 0 && !(wsub(ccap, a.cpu_used[n]) >= p.req_cpu)) return false;
    if (mcap != 0 && !(wsub(mcap, a.mem_used[n]) >= p.req_mem)) return false;
  }
  uint32_t clash = 0;
  for (int w = 0; w < a.L; ++w)
    clash |= p.words[w] & ~a.labels[(size_t)n * a.L + w];
  for (int w = 0; w < a.PW; ++w)
    clash |= a.port_bits[(size_t)n * a.PW + w] & p.words[a.L + w];
  for (int w = 0; w < a.K; ++w) {
    const size_t i = (size_t)n * a.K + w;
    clash |= (a.disk_any[i] & p.words[a.L + a.PW + w])
             | (a.disk_rw[i] & p.words[a.L + a.PW + a.K + w]);
  }
  if (clash != 0) return false;
  if (HAS_AFF) {
    for (int t = 0; t < a.NT; ++t) {
      const int dom = a.aff_dom[(size_t)t * a.N + n];
      const bool has_key = dom >= 0;
      const int count = has_key ? a.aff_count[(size_t)t * a.D + dom] : 0;
      if (p.terms[t]) {
        const bool boot = p.terms[2 * a.NT + t] > 0 && a.aff_total[t] == 0;
        if (!(has_key && (boot || count > 0))) return false;
      }
      if (p.terms[a.NT + t] && count != 0) return false;
    }
  }
  return true;
}

// floor(num / den) as _floordiv_exact computes it: a f64 estimate from
// the reciprocal, then two integer corrections
template <typename T>
__device__ __forceinline__ T floordiv_exact(T num, T den, double inv_den) {
  T e = (T)floor(__dmul_rn((double)num, inv_den));
  e = wadd(e, (T)(wmul(wadd(e, (T)1), den) <= num));
  e = wsub(e, (T)(wmul(e, den) > num));
  return e;
}

// 0..10 from 10 * (top - x) / max(top, 1), floored (SelectorSpread and
// ServiceAntiAffinity)
template <typename T>
__device__ __forceinline__ T tenths_below(int top, int x) {
  const double f = __ddiv_rn(__dmul_rn(10.0, (double)(top - x)),
                             (double)(top > 1 ? top : 1));
  return (T)floor(f);
}

// the priority total of pod p on slot n, ServiceAntiAffinity aside
template <typename T, bool HAS_SPREAD>
__device__ __forceinline__ T node_total(const Params<T>& a,
                                        const Pod<T>& p, int n) {
  const T ccap = a.cpu_cap[n], mcap = a.mem_cap[n];
  const T tc = wadd(a.nz_cpu[n], p.nz_cpu);
  const T tm = wadd(a.nz_mem[n], p.nz_mem);
  const T safe_cpu = ccap > (T)1 ? ccap : (T)1;
  const T safe_mem = mcap > (T)1 ? mcap : (T)1;
  const T cpu_score =
      (ccap == 0 || tc > ccap)
          ? (T)0
          : floordiv_exact(wmul(wsub(ccap, tc), (T)10), safe_cpu,
                           a.inv_cpu[n]);
  const T mem_score =
      (mcap == 0 || tm > mcap)
          ? (T)0
          : floordiv_exact(wmul(wsub(mcap, tm), (T)10), safe_mem,
                           a.inv_mem[n]);
  const T least_requested = wadd(cpu_score, mem_score) >> 1;
  const double cpu_frac =
      ccap == 0 ? 1.0 : __ddiv_rn((double)tc, (double)safe_cpu);
  const double mem_frac =
      mcap == 0 ? 1.0 : __ddiv_rn((double)tm, (double)safe_mem);
  const double diff = fabs(__dsub_rn(cpu_frac, mem_frac));
  const T balanced =
      (cpu_frac >= 1.0 || mem_frac >= 1.0)
          ? (T)0
          : (T)floor(__dsub_rn(10.0, __dmul_rn(diff, 10.0)));
  T total = wadd(wadd(wmul(a.w_lr, least_requested),
                      wmul(a.w_bal, balanced)),
                 a.static_score[n]);
  if (HAS_SPREAD) {
    T spread = (T)10;
    if (p.group_id >= 0 && p.maxc != 0)
      spread = tenths_below<T>(p.maxc, a.spread[(size_t)p.gid * a.N + n]);
    total = wadd(total, wmul(a.w_spread, spread));
  }
  return total;
}

// ServiceAntiAffinity's score on slot n, from the pod's zone histogram
template <typename T>
__device__ __forceinline__ T anti_score(const Params<T>& a, const Pod<T>& p,
                                        int n) {
  const int zone = a.zone_id[n];
  if (zone < 0) return (T)0;
  if (p.svc_tot <= 0) return (T)10;
  return tenths_below<T>(p.svc_tot, p.zones[zone]);
}

// slot n's contribution to the pod's zone histogram: its service count
// where it fits and carries the zone label
template <typename T>
__device__ __forceinline__ void add_zone(const Params<T>& a,
                                         const Pod<T>& p, int n) {
  const int zone = a.zone_id[n];
  if (zone >= 0) {
    const int g = p.svc_group > 0 ? p.svc_group : 0;
    atomicAdd(p.zones + zone, a.svc_count[(size_t)g * a.N + n]);
  }
}

// the block's largest value, returned to every thread
__device__ int block_max(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = max(v, __shfl_xor_sync(~0u, v, m));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : INT_MIN;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v = max(v, __shfl_xor_sync(~0u, v, m));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// the largest count of the pod's spread group over every slot, with the
// group's count on nodes off the table
template <typename T>
__device__ int spread_max(const Params<T>& a, const Pod<T>& p, int* red) {
  const int* row = a.spread + (size_t)p.gid * a.N;
  int m = INT_MIN;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) m = max(m, row[n]);
  m = block_max(m, red);
  return max(m, a.offgrid_max[p.gid]);
}

// (c, j) beats (d, i): the larger composite, then the smaller slot
template <typename T>
__device__ __forceinline__ bool beats(T c, int j, T d, int i) {
  return c > d || (c == d && j < i);
}

// the block's best (composite, slot), returned to every thread
template <typename T>
__device__ void block_best(T& c, int& j, long long* red_c, int* red_j) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    const T d = __shfl_xor_sync(~0u, c, m);
    const int i = __shfl_xor_sync(~0u, j, m);
    if (beats(d, i, c, j)) { c = d; j = i; }
  }
  if (lane == 0) { red_c[warp] = (long long)c; red_j[warp] = j; }
  __syncthreads();
  if (warp == 0) {
    const bool live = lane < (int)(blockDim.x >> 5);
    c = live ? (T)red_c[lane] : (T)-1;
    j = live ? red_j[lane] : INT_MAX;
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      const T d = __shfl_xor_sync(~0u, c, m);
      const int i = __shfl_xor_sync(~0u, j, m);
      if (beats(d, i, c, j)) { c = d; j = i; }
    }
    if (lane == 0) { red_c[32] = (long long)c; red_j[32] = j; }
  }
  __syncthreads();
  c = (T)red_c[32];
  j = red_j[32];
}

// offer slot n to this thread's running best: only fitting slots with a
// non-negative composite can be picked (engine: fit_any = best >= 0)
template <typename T>
__device__ __forceinline__ void offer(const Params<T>& a, T total, int n,
                                      T& best, int& best_j) {
  const T c = wadd(wmul(total, (T)a.N), (T)a.tie_rank[n]);
  if (c >= 0 && beats(c, n, best, best_j)) { best = c; best_j = n; }
}

template <typename T, bool HAS_SPREAD, bool HAS_AFF, bool ANTI>
__global__ void __launch_bounds__(SCAN_BLOCK_THREADS, 1)
scan_kernel(const Params<T> a) {
  extern __shared__ int smem[];
  __shared__ int red_max[33];
  __shared__ long long red_c[33];
  __shared__ int red_j[33];
  for (int k = 0; k < a.P; ++k) {
    if (!a.pod_valid[k]) {          // padded pods commit nothing
      if (threadIdx.x == 0) a.assigned[k] = -1;
      continue;
    }
    Pod<T> p = stage_pod<T, HAS_AFF, ANTI>(a, k, smem);
    if (HAS_SPREAD && p.group_id >= 0) p.maxc = spread_max(a, p, red_max);
    T best = (T)-1;
    int best_j = INT_MAX;
    if (!ANTI) {
      for (int n = threadIdx.x; n < a.N; n += blockDim.x)
        if (fits<T, HAS_AFF>(a, p, n))
          offer(a, node_total<T, HAS_SPREAD>(a, p, n), n, best, best_j);
    } else {
      for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
        const bool m = fits<T, HAS_AFF>(a, p, n);
        a.work_mask[n] = m;
        if (m) {
          a.work_total[n] = node_total<T, HAS_SPREAD>(a, p, n);
          add_zone(a, p, n);
        }
      }
      __syncthreads();
      for (int n = threadIdx.x; n < a.N; n += blockDim.x)
        if (a.work_mask[n])
          offer(a, wadd(a.work_total[n], wmul(a.w_anti, anti_score(a, p, n))),
                n, best, best_j);
    }
    block_best(best, best_j, red_c, red_j);
    if (best >= 0) {
      const int j = best_j;
      if (threadIdx.x == 0) {
        a.cpu_used[j] = wadd(a.cpu_used[j], p.req_cpu);
        a.mem_used[j] = wadd(a.mem_used[j], p.req_mem);
        a.nz_cpu[j] = wadd(a.nz_cpu[j], p.nz_cpu);
        a.nz_mem[j] = wadd(a.nz_mem[j], p.nz_mem);
        a.pod_count[j] += 1;
      }
      for (int i = threadIdx.x; i < a.PW; i += blockDim.x)
        a.port_bits[(size_t)j * a.PW + i] |= p.words[a.L + i];
      for (int i = threadIdx.x; i < a.K; i += blockDim.x) {
        a.disk_any[(size_t)j * a.K + i] |= a.sany[(size_t)k * a.K + i];
        a.disk_rw[(size_t)j * a.K + i] |= a.srw[(size_t)k * a.K + i];
      }
      if (HAS_SPREAD)
        for (int i = threadIdx.x; i < a.G; i += blockDim.x)
          a.spread[(size_t)i * a.N + j] += a.member[(size_t)k * a.G + i];
      if (HAS_AFF)
        for (int i = threadIdx.x; i < a.NT; i += blockDim.x) {
          const int add = p.terms[2 * a.NT + i];
          const int dom = a.aff_dom[(size_t)i * a.N + j];
          if (dom >= 0) a.aff_count[(size_t)i * a.D + dom] += add;
          a.aff_total[i] += add;
        }
      if (ANTI)
        for (int i = threadIdx.x; i < a.S; i += blockDim.x) {
          const int add = a.svc_member[(size_t)k * a.S + i];
          a.svc_count[(size_t)i * a.N + j] += add;
          a.svc_total[i] += add;
        }
    }
    if (threadIdx.x == 0) a.assigned[k] = best >= 0 ? best_j : -1;
    __syncthreads();                // the next pod sees this commit
  }
}

template <typename T, bool HAS_AFF, bool ANTI>
__global__ void __launch_bounds__(PROBE_BLOCK_THREADS)
probe_kernel(const Params<T> a) {
  extern __shared__ int smem[];
  __shared__ int red_max[33];
  const int k = blockIdx.x;
  Pod<T> p = stage_pod<T, HAS_AFF, ANTI>(a, k, smem);
  if (p.group_id >= 0) p.maxc = spread_max(a, p, red_max);
  uint8_t* mask = a.mask + (size_t)k * a.N;
  T* total = a.total + (size_t)k * a.N;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    const bool m = fits<T, HAS_AFF>(a, p, n);
    mask[n] = m;
    total[n] = node_total<T, true>(a, p, n);
    if (ANTI && m) add_zone(a, p, n);
  }
  if (ANTI) {
    __syncthreads();
    for (int n = threadIdx.x; n < a.N; n += blockDim.x)
      total[n] = wadd(total[n], wmul(a.w_anti, anti_score(a, p, n)));
  }
}

template <typename T>
static Params<T> unpack(const long long* d, const unsigned long long* q) {
  Params<T> a;
  a.P = (int)d[DIM_P]; a.N = (int)d[DIM_N]; a.L = (int)d[DIM_L];
  a.PW = (int)d[DIM_PW]; a.K = (int)d[DIM_K]; a.G = (int)d[DIM_G];
  a.NT = (int)d[DIM_T]; a.D = (int)d[DIM_D]; a.S = (int)d[DIM_S];
  a.Z = (int)d[DIM_Z];
  a.w_lr = (T)d[DIM_W_LR]; a.w_bal = (T)d[DIM_W_BAL];
  a.w_spread = (T)d[DIM_W_SPREAD]; a.w_anti = (T)d[DIM_W_ANTI];
#define P_(name, type) (type)(uintptr_t)q[name]
  a.valid = P_(PTR_VALID, const uint8_t*);
  a.sched_ok = P_(PTR_SCHED_OK, const uint8_t*);
  a.cpu_cap = P_(PTR_CPU_CAP, const T*);
  a.mem_cap = P_(PTR_MEM_CAP, const T*);
  a.pod_cap = P_(PTR_POD_CAP, const int*);
  a.labels = P_(PTR_LABELS, const uint32_t*);
  a.tie_rank = P_(PTR_TIE_RANK, const int*);
  a.exceed_cpu = P_(PTR_EXCEED_CPU, const uint8_t*);
  a.exceed_mem = P_(PTR_EXCEED_MEM, const uint8_t*);
  a.offgrid_max = P_(PTR_OFFGRID_MAX, const int*);
  a.aff_dom = P_(PTR_AFF_DOM, const int*);
  a.zone_id = P_(PTR_ZONE_ID, const int*);
  a.static_mask = P_(PTR_STATIC_MASK, const uint8_t*);
  a.static_score = P_(PTR_STATIC_SCORE, const T*);
  a.inv_cpu = P_(PTR_INV_CPU, const double*);
  a.inv_mem = P_(PTR_INV_MEM, const double*);
  a.cpu_used = P_(PTR_CPU_USED, T*);
  a.mem_used = P_(PTR_MEM_USED, T*);
  a.nz_cpu = P_(PTR_NZ_CPU, T*);
  a.nz_mem = P_(PTR_NZ_MEM, T*);
  a.pod_count = P_(PTR_POD_COUNT, int*);
  a.port_bits = P_(PTR_PORT_BITS, uint32_t*);
  a.disk_any = P_(PTR_DISK_ANY, uint32_t*);
  a.disk_rw = P_(PTR_DISK_RW, uint32_t*);
  a.spread = P_(PTR_SPREAD, int*);
  a.aff_count = P_(PTR_AFF_COUNT, int*);
  a.aff_total = P_(PTR_AFF_TOTAL, int*);
  a.svc_count = P_(PTR_SVC_COUNT, int*);
  a.svc_total = P_(PTR_SVC_TOTAL, int*);
  a.pod_valid = P_(PTR_POD_VALID, const uint8_t*);
  a.req_cpu = P_(PTR_REQ_CPU, const T*);
  a.req_mem = P_(PTR_REQ_MEM, const T*);
  a.zero_req = P_(PTR_ZERO_REQ, const uint8_t*);
  a.pod_nz_cpu = P_(PTR_POD_NZ_CPU, const T*);
  a.pod_nz_mem = P_(PTR_POD_NZ_MEM, const T*);
  a.sel = P_(PTR_SEL, const uint32_t*);
  a.ports = P_(PTR_PORTS, const uint32_t*);
  a.qany = P_(PTR_QANY, const uint32_t*);
  a.qrw = P_(PTR_QRW, const uint32_t*);
  a.sany = P_(PTR_SANY, const uint32_t*);
  a.srw = P_(PTR_SRW, const uint32_t*);
  a.host_idx = P_(PTR_HOST_IDX, const int*);
  a.group_id = P_(PTR_GROUP_ID, const int*);
  a.member = P_(PTR_MEMBER, const int*);
  a.aff_req = P_(PTR_AFF_REQ, const uint8_t*);
  a.anti_req = P_(PTR_ANTI_REQ, const uint8_t*);
  a.aff_member = P_(PTR_AFF_MEMBER, const int*);
  a.svc_group = P_(PTR_SVC_GROUP, const int*);
  a.svc_member = P_(PTR_SVC_MEMBER, const int*);
  a.assigned = P_(PTR_ASSIGNED, int*);
  a.mask = P_(PTR_MASK, uint8_t*);
  a.total = P_(PTR_TOTAL, T*);
  a.work_total = P_(PTR_WORK_TOTAL, T*);
  a.work_mask = P_(PTR_WORK_MASK, uint8_t*);
#undef P_
  return a;
}

template <typename K>
static cudaError_t shared_bytes(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, bool HAS_SPREAD, bool HAS_AFF, bool ANTI>
static cudaError_t launch(int kind, int threads, size_t smem,
                          const long long* dims,
                          const unsigned long long* ptrs,
                          cudaStream_t stream) {
  const Params<T> a = unpack<T>(dims, ptrs);
  cudaError_t err;
  if (kind == 0) {
    err = shared_bytes(scan_kernel<T, HAS_SPREAD, HAS_AFF, ANTI>, smem);
    if (err != cudaSuccess) return err;
    scan_kernel<T, HAS_SPREAD, HAS_AFF, ANTI>
        <<<1, threads, smem, stream>>>(a);
  } else {
    if (!HAS_SPREAD) return cudaErrorInvalidValue;   // probes score spread
    err = shared_bytes(probe_kernel<T, HAS_AFF, ANTI>, smem);
    if (err != cudaSuccess) return err;
    probe_kernel<T, HAS_AFF, ANTI><<<a.P, threads, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

// kind 0: K1 over a chunk (one block); kind 1: K5 (one block a pod).
// variant: bit 3 the int64 layout, bit 2 the spread tier, bit 1 the
// affinity tier, bit 0 ServiceAntiAffinity (scan_kernel.launch_plan).
extern "C" int scan_launch(int kind, int variant, int threads,
                           long long smem, const long long* dims,
                           const unsigned long long* ptrs, void* stream) {
  if (kind < 0 || kind > 1 || dims[DIM_P] <= 0 || dims[DIM_N] <= 0)
    return (int)cudaErrorInvalidValue;
  const long long need =
      4 * (dims[DIM_Z] + dims[DIM_L] + dims[DIM_PW] + 2 * dims[DIM_K]
           + 3 * dims[DIM_T]);
  if (smem < need || smem > SCAN_MAX_SHARED_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t b = (size_t)smem;
  switch (variant) {
    case 0: return (int)launch<int32_t, false, false, false>(kind, threads, b, dims, ptrs, s);
    case 1: return (int)launch<int32_t, false, false, true>(kind, threads, b, dims, ptrs, s);
    case 2: return (int)launch<int32_t, false, true, false>(kind, threads, b, dims, ptrs, s);
    case 3: return (int)launch<int32_t, false, true, true>(kind, threads, b, dims, ptrs, s);
    case 4: return (int)launch<int32_t, true, false, false>(kind, threads, b, dims, ptrs, s);
    case 5: return (int)launch<int32_t, true, false, true>(kind, threads, b, dims, ptrs, s);
    case 6: return (int)launch<int32_t, true, true, false>(kind, threads, b, dims, ptrs, s);
    case 7: return (int)launch<int32_t, true, true, true>(kind, threads, b, dims, ptrs, s);
    case 8: return (int)launch<int64_t, false, false, false>(kind, threads, b, dims, ptrs, s);
    case 9: return (int)launch<int64_t, false, false, true>(kind, threads, b, dims, ptrs, s);
    case 10: return (int)launch<int64_t, false, true, false>(kind, threads, b, dims, ptrs, s);
    case 11: return (int)launch<int64_t, false, true, true>(kind, threads, b, dims, ptrs, s);
    case 12: return (int)launch<int64_t, true, false, false>(kind, threads, b, dims, ptrs, s);
    case 13: return (int)launch<int64_t, true, false, true>(kind, threads, b, dims, ptrs, s);
    case 14: return (int)launch<int64_t, true, true, false>(kind, threads, b, dims, ptrs, s);
    case 15: return (int)launch<int64_t, true, true, true>(kind, threads, b, dims, ptrs, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* scan_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
