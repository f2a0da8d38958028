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
// resources, int64 otherwise); it reads a slot's fields through an
// accessor (SharedSlots: K1's on-chip copy; GlobalSlots: the tables).
// Integer arithmetic in T wraps as the tensors' does (wadd / wsub / wmul
// through the unsigned type). Every f64 formula is written with
// __dmul_rn / __dsub_rn / __ddiv_rn, which nvcc never contracts into an
// FMA: Balanced's 10 - diff * 10 fused into one DFMA drops the floor by
// one where diff * 10 is exactly an integer (cpu_frac 0.9, mem_frac 0),
// the fault of the JAX probe on the CPU. The exact floor division
// (_floordiv_exact) is repeated as it is: the f64 reciprocal-multiply
// estimate and its two integer corrections.
//
// Bound: operations (sched/device/bounds.py scan_ops / probe_ops). At
// 8192 pods x 5120 slots, ~70 INT32 and ~45 FP64 instructions an
// element give 0.1406 ms for the whole card (bounds.scan_bound). The
// pods are a chain: pod k + 1 sees pod k's commit, so a chunk cannot
// spread over the card's 132 SMs pod by pod, and one SM walking the
// chunk alone sits ~850x above that bound.
//
// Design. K1 is one launch of one thread-block cluster of C CTAs (16,
// non-portable, where the card can schedule it at the kernel's shared
// memory, else 8; scan_max_clusters answers, scan_kernel.launch_plan
// picks). The node axis is split: CTA r owns the contiguous slots
// [r * S, r * S + S), S = ceil(N / C), and its thread t < blockDim.x -
// 32 the slots r * S + t + i * (blockDim.x - 32), for the whole chunk.
// The fixed-width fields of its slots (node constants: flags, caps, pod
// cap, tie rank, zone, static score, reciprocals, label words; State:
// used and non-zero resources, pod count, port and disk words) are
// copied into the CTA's shared memory once at the start and written
// back once at the end, so the owning thread scores and commits from its
// own copy and no pod needs a barrier for its own slot's commit. The
// group-indexed State (spread and service counts by slot, the affinity
// domain counts, the totals) stays in global memory: a slot's column is
// only read and written by its owner; the counts shared by the cluster
// (aff_count, aff_total, svc_total) are committed by CTA 0 and published
// by a cluster barrier. Per pod on the node-local tier: the owners score
// their slots; the CTA reduces its best (composite, slot) with redux.sync
// and one __syncthreads; warp 0 writes it into every CTA's inbox with
// st.async, which counts the bytes off that CTA's mbarrier (one of two,
// by exchange parity); every thread waits on its own CTA's barrier and
// reads the C records locally, so all CTAs reach the same winner by the
// same order as beats(); the winner's owner commits. No cluster-wide
// barrier a pod: a CTA cannot write an inbox record again before its
// owner has read it, since that needs the owner's own next record. The
// spread tier adds the group max of spread[gid, :] as a cluster
// reduction (cluster barrier, distributed shared memory);
// ServiceAntiAffinity one for the zone histogram (partials summed over
// the cluster) and, like the affinity tier, one that publishes CTA 0's
// commit of the shared counts. The CTA's last warp owns no slot: it
// stages pod k + 1's row (scalars, bitset words, terms, group and
// service members) into a ring of three in shared memory while the
// others score pod k, so the row's load is off the chain. Invalid
// (padded) pods commit nothing and write -1.
// Ceiling: C SMs of the card's 132, so the whole-card bound stays out of
// reach (~8x at C = 16); the speculative engine (K6, queued) is the
// card-wide route.
// K5: a cluster of C CTAs a pod (C in 1, 2, 4, 8, 16, so that P x C
// covers the card's SMs: 16 at the extender's one pod, 1 for a batch of
// 132 or more; scan_kernel.launch_plan), the node axis split over the
// CTAs as K1 splits it, the same body read from the tables, no commit.
// Two phases in one launch: each CTA's part of the spread group's max
// and, with ServiceAntiAffinity, of the zone histogram of the fitting
// slots; one cluster barrier and the partials read over distributed
// shared memory (the helpers K1 uses); then the totals. At C = 1 (a
// batch of 132 pods or more) it is one block a pod: the group max, then
// the mask and totals, and with ANTI a second pass.
//
// The sharded K1 (scan_sharded_kernel, shard_launch) replaces the same
// scan jitted over a node-axis mesh (engine.py _get_run with
// _node_shardings): K1's body with a cluster a shard over the shard's
// block of slots, and after each of the cluster's reductions a pod the
// exchange between the shards (K7, below). It computes K1's function
// (K1's bound); K7 adds a round trip through L2 a reduction a pod.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; scan_launch, shard_launch and scan_max_clusters are
// the plain-C entry points that
// kubernetes_tpu_torch/sched/device/scan_kernel.py calls through ctypes,
// with the tensors' addresses in the order of enum ScanPtr, the sizes and
// weights in the order of enum ScanDim, and the shard arguments in the
// order of enum ShardArg.

#include <climits>
#include <cstdint>
#include <type_traits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

#define SCAN_BLOCK_THREADS 384
#define PROBE_BLOCK_THREADS 512
#define SCAN_MAX_SHARED_BYTES 232448
#define SCAN_MAX_CLUSTER 16
#define SPEC_REPAIR_THREADS 384

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
  PTR_SPEC_NODES, PTR_COUNT
};

// the sizes and weights the wrapper packs (scan_kernel.DIM_FIELDS)
enum ScanDim {
  DIM_P, DIM_N, DIM_L, DIM_PW, DIM_K, DIM_G, DIM_T, DIM_D, DIM_S, DIM_Z,
  DIM_W_LR, DIM_W_BAL, DIM_W_SPREAD, DIM_W_ANTI, DIM_COUNT
};

// the sharded K1's arguments (scan_kernel.SHARD_FIELDS): the mesh's
// shards, the slots a shard owns, the spin budget in cycles (0:
// K7_BUDGET), the shard that withholds its first candidate record (-1:
// none), the exchange buffer's int64 words, its address and the
// replicas' address
enum ShardArg {
  SHARD_SHARDS, SHARD_BLOCK, SHARD_BUDGET, SHARD_WITHHOLD, SHARD_XWORDS,
  SHARD_XCHG, SHARD_REPLICA, SHARD_COUNT
};

// cycles a K7 spin may wait for a record before the kernel traps (~2 s
// at the H100's clocks): a shard that never posts raises, never hangs
#define K7_BUDGET (1LL << 32)
// the most shards: a warp's lanes read the shards' records
#define K7_MAX_SHARDS 32

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
  uint8_t* work_mask;           // K1 [N], ANTI only; K6b [P] (slow pods)
  int* spec_nodes;              // K6 [b, b]: the slots of `total`'s lists
  // the sharded K1 (K7): see enum ShardArg; zero for the other kernels
  int shards, shard_block, withhold;
  long long budget;
  unsigned long long* xchg;     // K7's exchange buffer
  int* replica;                 // [shards - 1, R] the replicated counts
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

// The pod row as 32-bit words, as K1's ring and K5's stage hold it:
// valid, zero_req, host_idx, group_id, svc_group; req_cpu, req_mem,
// nz_cpu, nz_mem (one or two words each); sel [L], ports [PW], qany,
// qrw, sany, srw [K]; with HAS_AFF aff_req, anti_req, aff_member [NT];
// with HAS_SPREAD member [G]; with ANTI svc_member [S].
template <typename T, bool HAS_SPREAD, bool HAS_AFF, bool ANTI>
__device__ __forceinline__ int pod_words(const Params<T>& a) {
  constexpr int W = sizeof(T) / 4;
  return 5 + 4 * W + a.L + a.PW + 4 * a.K + (HAS_AFF ? 3 * a.NT : 0)
         + (HAS_SPREAD ? a.G : 0) + (ANTI ? a.S : 0);
}

// the address of word e of pod k's row; *byte: a one-byte flag
template <typename T, bool HAS_SPREAD, bool HAS_AFF, bool ANTI>
__device__ const void* pod_src(const Params<T>& a, int k, int e, bool* byte) {
  constexpr int W = sizeof(T) / 4;
  *byte = false;
  switch (e) {
    case 0: *byte = true; return a.pod_valid + k;
    case 1: *byte = true; return a.zero_req + k;
    case 2: return a.host_idx + k;
    case 3: return a.group_id + k;
    case 4: return a.svc_group + k;
    default: break;
  }
  e -= 5;
  if (e < 4 * W) {
    const int f = e / W;
    const T* src = f == 0 ? a.req_cpu : f == 1 ? a.req_mem
                 : f == 2 ? a.pod_nz_cpu : a.pod_nz_mem;
    return (const uint32_t*)(src + k) + e % W;
  }
  e -= 4 * W;
  if (e < a.L) return a.sel + (size_t)k * a.L + e;
  e -= a.L;
  if (e < a.PW) return a.ports + (size_t)k * a.PW + e;
  e -= a.PW;
  if (e < 4 * a.K) {
    const int f = e / a.K;
    const uint32_t* src = f == 0 ? a.qany : f == 1 ? a.qrw
                        : f == 2 ? a.sany : a.srw;
    return src + (size_t)k * a.K + e % a.K;
  }
  e -= 4 * a.K;
  if (HAS_AFF) {
    *byte = e < 2 * a.NT;
    if (e < a.NT) return a.aff_req + (size_t)k * a.NT + e;
    if (e < 2 * a.NT) return a.anti_req + (size_t)k * a.NT + e - a.NT;
    if (e < 3 * a.NT) return a.aff_member + (size_t)k * a.NT + e - 2 * a.NT;
    e -= 3 * a.NT;
  }
  if (HAS_SPREAD) {
    if (e < a.G) return a.member + (size_t)k * a.G + e;
    e -= a.G;
  }
  return a.svc_member + (size_t)k * a.S + e;
}

// one 32-bit word (a byte zero-extended where `byte`) from global
// memory, by two predicated loads into one register: the lanes of the
// loader warp take different fields, and a value merged from divergent
// branches would cost a wait a branch; this costs one a word
__device__ __forceinline__ uint32_t load_word(const void* p, bool byte) {
  uint32_t v;
  asm volatile(
      "{\n.reg .pred b;\nsetp.ne.u32 b, %2, 0;\n"
      "@b ld.global.u8 %0, [%1];\n@!b ld.global.u32 %0, [%1];\n}"
      : "=r"(v) : "l"(__cvta_generic_to_global(p)), "r"((uint32_t)byte));
  return v;
}

template <typename T, bool HAS_SPREAD, bool HAS_AFF, bool ANTI>
__device__ __forceinline__ uint32_t pod_word(const Params<T>& a, int k,
                                             int e) {
  bool byte;
  const void* p = pod_src<T, HAS_SPREAD, HAS_AFF, ANTI>(a, k, e, &byte);
  return load_word(p, byte);
}

template <typename T>
__device__ __forceinline__ T word_t(const uint32_t* w) {
  if (sizeof(T) == 4) return (T)w[0];
  return (T)(((uint64_t)w[1] << 32) | w[0]);
}

// One pod, read by every thread from its staged row.
template <typename T>
struct Pod {
  bool valid, zero_req;
  T req_cpu, req_mem, nz_cpu, nz_mem;
  int host_idx, group_id, gid, svc_group, svc_tot, maxc;
  const uint32_t* words;   // sel [L], ports [PW], qany, qrw, sany, srw [K]
  const int* terms;        // aff_req, anti_req, aff_member [NT]
  const int* member;       // [G]
  const int* svc_member;   // [S]
  const int* zones;        // zone histogram [Z] (ANTI)
};

template <typename T, bool HAS_SPREAD, bool HAS_AFF, bool ANTI>
__device__ __forceinline__ Pod<T> read_pod(const Params<T>& a,
                                           const uint32_t* row) {
  constexpr int W = sizeof(T) / 4;
  Pod<T> p;
  p.valid = row[0] != 0;
  p.zero_req = row[1] != 0;
  p.host_idx = (int)row[2];
  p.group_id = (int)row[3];
  p.gid = p.group_id > 0 ? p.group_id : 0;
  p.svc_group = (int)row[4];
  p.req_cpu = word_t<T>(row + 5);
  p.req_mem = word_t<T>(row + 5 + W);
  p.nz_cpu = word_t<T>(row + 5 + 2 * W);
  p.nz_mem = word_t<T>(row + 5 + 3 * W);
  p.words = row + 5 + 4 * W;
  const int* rest = (const int*)(p.words + a.L + a.PW + 4 * a.K);
  p.terms = rest;
  if (HAS_AFF) rest += 3 * a.NT;
  p.member = rest;
  if (HAS_SPREAD) rest += a.G;
  p.svc_member = rest;
  p.svc_tot = 0;
  if (ANTI && p.svc_group >= 0) p.svc_tot = a.svc_total[p.svc_group];
  p.maxc = 0;
  p.zones = nullptr;
  return p;
}

// A slot's fields straight from the tables (K5), index i = slot n.
template <typename T>
struct GlobalSlots {
  const Params<T>& a;
  __device__ bool ok(int n) const {
    return a.valid[n] && a.sched_ok[n] && a.static_mask[n];
  }
  __device__ bool exceed(int n) const {
    return a.exceed_cpu[n] || a.exceed_mem[n];
  }
  __device__ T cpu_cap(int n) const { return a.cpu_cap[n]; }
  __device__ T mem_cap(int n) const { return a.mem_cap[n]; }
  __device__ int pod_cap(int n) const { return a.pod_cap[n]; }
  __device__ int tie_rank(int n) const { return a.tie_rank[n]; }
  __device__ int zone_id(int n) const { return a.zone_id[n]; }
  __device__ T static_score(int n) const { return a.static_score[n]; }
  __device__ double inv_cpu(int n) const { return a.inv_cpu[n]; }
  __device__ double inv_mem(int n) const { return a.inv_mem[n]; }
  __device__ uint32_t label(int n, int w) const {
    return a.labels[(size_t)n * a.L + w];
  }
  __device__ T cpu_used(int n) const { return a.cpu_used[n]; }
  __device__ T mem_used(int n) const { return a.mem_used[n]; }
  __device__ T nz_cpu(int n) const { return a.nz_cpu[n]; }
  __device__ T nz_mem(int n) const { return a.nz_mem[n]; }
  __device__ int pod_count(int n) const { return a.pod_count[n]; }
  __device__ uint32_t port(int n, int w) const {
    return a.port_bits[(size_t)n * a.PW + w];
  }
  __device__ uint32_t disk_any(int n, int w) const {
    return a.disk_any[(size_t)n * a.K + w];
  }
  __device__ uint32_t disk_rw(int n, int w) const {
    return a.disk_rw[(size_t)n * a.K + w];
  }
};

// The block's commits to the slots its pods take (K6b), one record a
// taken slot and a last one of zeros: the resources, count, port and
// disk bits and spread counts the commits add.
template <typename T>
struct Deltas {
  T *cpu_used, *mem_used, *nz_cpu, *nz_mem;
  int* pod_count;
  uint32_t *ports, *dany, *drw;
  int* spread;     // [records][groups]
  int groups;      // G on the spread tier, else 0
};

// carve `r` records from `base` (T first, then 32-bit words) -> the
// first byte after them (spec_kernel.repair_bytes)
template <typename T>
__device__ uint8_t* carve(Deltas<T>& d, uint8_t* base, int r, int PW,
                          int K, int G) {
  T* t = (T*)base;
  d.cpu_used = t; d.mem_used = t + r; d.nz_cpu = t + 2 * r;
  d.nz_mem = t + 3 * r;
  uint32_t* w = (uint32_t*)(t + 4 * r);
  d.pod_count = (int*)w; w += r;
  d.ports = w; w += r * PW;
  d.dany = w; w += r * K;
  d.drw = w; w += r * K;
  d.spread = (int*)w; w += r * G;
  d.groups = G;
  return (uint8_t*)w;
}

// Slot n's fields as the block's commits left them: the tables' plus
// record i of `d`, and with PLUS pod *c's commit on top (as if the pod
// were committed there); GlobalSlots' accessors, index n.
template <typename T, bool PLUS = false>
struct LiveSlot {
  const Params<T>& a;
  const Deltas<T>& d;
  int i;
  const Pod<T>* c;
  __device__ bool ok(int n) const {
    return a.valid[n] & a.sched_ok[n] & a.static_mask[n];
  }
  __device__ bool exceed(int n) const {
    return a.exceed_cpu[n] | a.exceed_mem[n];
  }
  __device__ T cpu_cap(int n) const { return a.cpu_cap[n]; }
  __device__ T mem_cap(int n) const { return a.mem_cap[n]; }
  __device__ int pod_cap(int n) const { return a.pod_cap[n]; }
  __device__ int tie_rank(int n) const { return a.tie_rank[n]; }
  __device__ int zone_id(int n) const { return a.zone_id[n]; }
  __device__ T static_score(int n) const { return a.static_score[n]; }
  __device__ double inv_cpu(int n) const { return a.inv_cpu[n]; }
  __device__ double inv_mem(int n) const { return a.inv_mem[n]; }
  __device__ uint32_t label(int n, int w) const {
    return a.labels[(size_t)n * a.L + w];
  }
  __device__ T plus(T v, T add) const { return PLUS ? wadd(v, add) : v; }
  __device__ T cpu_used(int n) const {
    return plus(wadd(a.cpu_used[n], d.cpu_used[i]), PLUS ? c->req_cpu : 0);
  }
  __device__ T mem_used(int n) const {
    return plus(wadd(a.mem_used[n], d.mem_used[i]), PLUS ? c->req_mem : 0);
  }
  __device__ T nz_cpu(int n) const {
    return plus(wadd(a.nz_cpu[n], d.nz_cpu[i]), PLUS ? c->nz_cpu : 0);
  }
  __device__ T nz_mem(int n) const {
    return plus(wadd(a.nz_mem[n], d.nz_mem[i]), PLUS ? c->nz_mem : 0);
  }
  __device__ int pod_count(int n) const {
    return a.pod_count[n] + d.pod_count[i] + PLUS;
  }
  // commit_slot's words of pod *c: ports at L, disks at L + PW + 2K
  // (any) and L + PW + 3K (rw)
  __device__ uint32_t port(int n, int w) const {
    return a.port_bits[(size_t)n * a.PW + w] | d.ports[i * a.PW + w]
           | (PLUS ? c->words[a.L + w] : 0u);
  }
  __device__ uint32_t disk_any(int n, int w) const {
    return a.disk_any[(size_t)n * a.K + w] | d.dany[i * a.K + w]
           | (PLUS ? c->words[a.L + a.PW + 2 * a.K + w] : 0u);
  }
  __device__ uint32_t disk_rw(int n, int w) const {
    return a.disk_rw[(size_t)n * a.K + w] | d.drw[i * a.K + w]
           | (PLUS ? c->words[a.L + a.PW + 3 * a.K + w] : 0u);
  }
};

template <typename T, bool PLUS>
__device__ __forceinline__ int spread_count(const Params<T>& a,
                                            const LiveSlot<T, PLUS>& s,
                                            int g, int n) {
  return a.spread[(size_t)g * a.N + n] + s.d.spread[s.i * a.G + g]
         + (PLUS ? s.c->member[g] : 0);
}

// One slot's fields for pod p in registers (K6b): every load issued at
// once, the label, port and disk words already reduced to the pod's
// clash and the spread counts to its group's. A rescore's latency is
// K6b's step, and node_total and fits, reading their fields between
// their branches, would send the loads out a few at a time. The
// accessors of GlobalSlots, the index ignored.
template <typename T>
struct RegSlot {
  T cpu_cap_, mem_cap_, static_score_, cpu_used_, mem_used_, nz_cpu_,
      nz_mem_;
  double inv_cpu_, inv_mem_;
  int pod_cap_, pod_count_, tie_rank_, spread_;
  uint32_t clash_;
  bool ok_, exceed_;
  __device__ bool ok(int) const { return ok_; }
  __device__ bool exceed(int) const { return exceed_; }
  __device__ T cpu_cap(int) const { return cpu_cap_; }
  __device__ T mem_cap(int) const { return mem_cap_; }
  __device__ int pod_cap(int) const { return pod_cap_; }
  __device__ int tie_rank(int) const { return tie_rank_; }
  __device__ T static_score(int) const { return static_score_; }
  __device__ double inv_cpu(int) const { return inv_cpu_; }
  __device__ double inv_mem(int) const { return inv_mem_; }
  __device__ T cpu_used(int) const { return cpu_used_; }
  __device__ T mem_used(int) const { return mem_used_; }
  __device__ T nz_cpu(int) const { return nz_cpu_; }
  __device__ T nz_mem(int) const { return nz_mem_; }
  __device__ int pod_count(int) const { return pod_count_; }
};

template <typename T>
__device__ __forceinline__ int spread_count(const Params<T>&,
                                            const RegSlot<T>& r, int, int) {
  return r.spread_;
}

// A CTA's copy of its S slots in shared memory (K1), index i = the
// slot's place in the CTA's range. Carved f64 first, then T, then
// 32-bit, then bytes, so every array is aligned; 8 bytes a slot of
// flags: bit 0 valid & sched_ok & static_mask, bit 1 an exceeded node.
template <typename T>
struct SharedSlots {
  double *inv_cpu_, *inv_mem_;
  T *cpu_cap_, *mem_cap_, *static_score_;
  T *cpu_used_, *mem_used_, *nz_cpu_, *nz_mem_;
  int *pod_cap_, *pod_count_, *tie_rank_, *zone_id_;
  uint32_t *labels_, *ports_, *dany_, *drw_;
  uint8_t* flags_;
  int L, PW, K;

  __device__ bool ok(int i) const { return flags_[i] & 1; }
  __device__ bool exceed(int i) const { return flags_[i] & 2; }
  __device__ T cpu_cap(int i) const { return cpu_cap_[i]; }
  __device__ T mem_cap(int i) const { return mem_cap_[i]; }
  __device__ int pod_cap(int i) const { return pod_cap_[i]; }
  __device__ int tie_rank(int i) const { return tie_rank_[i]; }
  __device__ int zone_id(int i) const { return zone_id_[i]; }
  __device__ T static_score(int i) const { return static_score_[i]; }
  __device__ double inv_cpu(int i) const { return inv_cpu_[i]; }
  __device__ double inv_mem(int i) const { return inv_mem_[i]; }
  __device__ uint32_t label(int i, int w) const { return labels_[i * L + w]; }
  __device__ T cpu_used(int i) const { return cpu_used_[i]; }
  __device__ T mem_used(int i) const { return mem_used_[i]; }
  __device__ T nz_cpu(int i) const { return nz_cpu_[i]; }
  __device__ T nz_mem(int i) const { return nz_mem_[i]; }
  __device__ int pod_count(int i) const { return pod_count_[i]; }
  __device__ uint32_t port(int i, int w) const { return ports_[i * PW + w]; }
  __device__ uint32_t disk_any(int i, int w) const {
    return dany_[i * K + w];
  }
  __device__ uint32_t disk_rw(int i, int w) const { return drw_[i * K + w]; }
};

// bytes of shared memory a slot takes in SharedSlots (scan_kernel.py
// slot_bytes)
template <typename T>
__host__ __device__ constexpr long long slot_bytes(long long L, long long PW,
                                                   long long K) {
  return 16 + 7 * (long long)sizeof(T) + 16 + 4 * (L + PW + 2 * K) + 1;
}

// carve S slots from `base`; -> the first byte after them
template <typename T>
__device__ uint8_t* carve(SharedSlots<T>& s, uint8_t* base, int S, int L,
                          int PW, int K) {
  s.L = L; s.PW = PW; s.K = K;
  double* d = (double*)base;
  s.inv_cpu_ = d; s.inv_mem_ = d + S;
  T* t = (T*)(d + 2 * S);
  s.cpu_cap_ = t; s.mem_cap_ = t + S; s.static_score_ = t + 2 * S;
  s.cpu_used_ = t + 3 * S; s.mem_used_ = t + 4 * S;
  s.nz_cpu_ = t + 5 * S; s.nz_mem_ = t + 6 * S;
  int* w = (int*)(t + 7 * S);
  s.pod_cap_ = w; s.pod_count_ = w + S; s.tie_rank_ = w + 2 * S;
  s.zone_id_ = w + 3 * S;
  uint32_t* u = (uint32_t*)(w + 4 * S);
  s.labels_ = u; u += S * L;
  s.ports_ = u; u += S * PW;
  s.dany_ = u; u += S * K;
  s.drw_ = u; u += S * K;
  return (uint8_t*)u;   // the flags go last, after the ring and zones
}

// slot n's fields from the tables into index i of K1's SharedSlots copy
template <typename T>
__device__ __forceinline__ void load_slot(const Params<T>& a,
                                          SharedSlots<T>& s, int i, int n) {
  s.flags_[i] = (a.valid[n] && a.sched_ok[n] && a.static_mask[n])
                | ((a.exceed_cpu[n] || a.exceed_mem[n]) << 1);
  s.inv_cpu_[i] = a.inv_cpu[n];
  s.inv_mem_[i] = a.inv_mem[n];
  s.cpu_cap_[i] = a.cpu_cap[n];
  s.mem_cap_[i] = a.mem_cap[n];
  s.static_score_[i] = a.static_score[n];
  s.cpu_used_[i] = a.cpu_used[n];
  s.mem_used_[i] = a.mem_used[n];
  s.nz_cpu_[i] = a.nz_cpu[n];
  s.nz_mem_[i] = a.nz_mem[n];
  s.pod_cap_[i] = a.pod_cap[n];
  s.pod_count_[i] = a.pod_count[n];
  s.tie_rank_[i] = a.tie_rank[n];
  s.zone_id_[i] = a.zone_id[n];
  for (int w = 0; w < a.L; ++w)
    s.labels_[i * a.L + w] = a.labels[(size_t)n * a.L + w];
  for (int w = 0; w < a.PW; ++w)
    s.ports_[i * a.PW + w] = a.port_bits[(size_t)n * a.PW + w];
  for (int w = 0; w < a.K; ++w) {
    s.dany_[i * a.K + w] = a.disk_any[(size_t)n * a.K + w];
    s.drw_[i * a.K + w] = a.disk_rw[(size_t)n * a.K + w];
  }
}

// the State of index i of a SharedSlots copy back into slot n's columns
template <typename T>
__device__ __forceinline__ void store_slot(const Params<T>& a,
                                           const SharedSlots<T>& s, int i,
                                           int n) {
  a.cpu_used[n] = s.cpu_used_[i];
  a.mem_used[n] = s.mem_used_[i];
  a.nz_cpu[n] = s.nz_cpu_[i];
  a.nz_mem[n] = s.nz_mem_[i];
  a.pod_count[n] = s.pod_count_[i];
  for (int w = 0; w < a.PW; ++w)
    a.port_bits[(size_t)n * a.PW + w] = s.ports_[i * a.PW + w];
  for (int w = 0; w < a.K; ++w) {
    a.disk_any[(size_t)n * a.K + w] = s.dany_[i * a.K + w];
    a.disk_rw[(size_t)n * a.K + w] = s.drw_[i * a.K + w];
  }
}

// the predicate mask of pod p on slot n (its fields at index i of s)
template <typename T, bool HAS_AFF, typename Slots>
__device__ __forceinline__ bool fits(const Params<T>& a, const Pod<T>& p,
                                     const Slots& s, int i, int n) {
  if (!(p.valid && s.ok(i))) return false;
  if (p.host_idx != -1 && p.host_idx != n) return false;
  if (!(s.pod_count(i) < s.pod_cap(i))) return false;
  if (!p.zero_req) {
    if (s.exceed(i)) return false;
    const T ccap = s.cpu_cap(i), mcap = s.mem_cap(i);
    if (ccap != 0 && !(wsub(ccap, s.cpu_used(i)) >= p.req_cpu)) return false;
    if (mcap != 0 && !(wsub(mcap, s.mem_used(i)) >= p.req_mem)) return false;
  }
  uint32_t clash = 0;
  for (int w = 0; w < a.L; ++w) clash |= p.words[w] & ~s.label(i, w);
  for (int w = 0; w < a.PW; ++w) clash |= s.port(i, w) & p.words[a.L + w];
  for (int w = 0; w < a.K; ++w)
    clash |= (s.disk_any(i, w) & p.words[a.L + a.PW + w])
             | (s.disk_rw(i, w) & p.words[a.L + a.PW + a.K + w]);
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

// the count of spread group g on slot n (K6b's LiveSlot adds the block's
// commits)
template <typename T, typename Slots>
__device__ __forceinline__ int spread_count(const Params<T>& a, const Slots&,
                                            int g, int n) {
  return a.spread[(size_t)g * a.N + n];
}

// the priority total of pod p on slot n, ServiceAntiAffinity aside
template <typename T, bool HAS_SPREAD, typename Slots>
__device__ __forceinline__ T node_total(const Params<T>& a,
                                        const Pod<T>& p, const Slots& s,
                                        int i, int n) {
  const T ccap = s.cpu_cap(i), mcap = s.mem_cap(i);
  const T tc = wadd(s.nz_cpu(i), p.nz_cpu);
  const T tm = wadd(s.nz_mem(i), p.nz_mem);
  const T safe_cpu = ccap > (T)1 ? ccap : (T)1;
  const T safe_mem = mcap > (T)1 ? mcap : (T)1;
  const T cpu_score =
      (ccap == 0 || tc > ccap)
          ? (T)0
          : floordiv_exact(wmul(wsub(ccap, tc), (T)10), safe_cpu,
                           s.inv_cpu(i));
  const T mem_score =
      (mcap == 0 || tm > mcap)
          ? (T)0
          : floordiv_exact(wmul(wsub(mcap, tm), (T)10), safe_mem,
                           s.inv_mem(i));
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
                 s.static_score(i));
  if (HAS_SPREAD) {
    T spread = (T)10;
    if (p.group_id >= 0 && p.maxc != 0)
      spread = tenths_below<T>(p.maxc, spread_count(a, s, p.gid, n));
    total = wadd(total, wmul(a.w_spread, spread));
  }
  return total;
}

// slot n's fields for pod p from `s` into registers (RegSlot)
template <typename T, bool HAS_SPREAD, typename Slots>
__device__ __forceinline__ RegSlot<T> reg_slot(const Params<T>& a,
                                               const Pod<T>& p,
                                               const Slots& s, int n) {
  RegSlot<T> r;
  r.ok_ = s.ok(n);
  r.exceed_ = s.exceed(n);
  r.cpu_cap_ = s.cpu_cap(n);
  r.mem_cap_ = s.mem_cap(n);
  r.static_score_ = s.static_score(n);
  r.cpu_used_ = s.cpu_used(n);
  r.mem_used_ = s.mem_used(n);
  r.nz_cpu_ = s.nz_cpu(n);
  r.nz_mem_ = s.nz_mem(n);
  r.inv_cpu_ = s.inv_cpu(n);
  r.inv_mem_ = s.inv_mem(n);
  r.pod_cap_ = s.pod_cap(n);
  r.pod_count_ = s.pod_count(n);
  r.tie_rank_ = s.tie_rank(n);
  r.spread_ = HAS_SPREAD && p.group_id >= 0 ? spread_count(a, s, p.gid, n)
                                            : 0;
  uint32_t clash = 0;
  for (int w = 0; w < a.L; ++w) clash |= p.words[w] & ~s.label(n, w);
  for (int w = 0; w < a.PW; ++w) clash |= s.port(n, w) & p.words[a.L + w];
  for (int w = 0; w < a.K; ++w)
    clash |= (s.disk_any(n, w) & p.words[a.L + a.PW + w])
             | (s.disk_rw(n, w) & p.words[a.L + a.PW + a.K + w]);
  r.clash_ = clash;
  return r;
}

// fits() without the affinity tier on a RegSlot
template <typename T>
__device__ __forceinline__ bool fits_reg(const Pod<T>& p,
                                         const RegSlot<T>& r, int n) {
  const bool cpu = (r.cpu_cap_ == 0)
                   | (wsub(r.cpu_cap_, r.cpu_used_) >= p.req_cpu);
  const bool mem = (r.mem_cap_ == 0)
                   | (wsub(r.mem_cap_, r.mem_used_) >= p.req_mem);
  return p.valid & r.ok_ & ((p.host_idx == -1) | (p.host_idx == n))
         & (r.pod_count_ < r.pod_cap_)
         & (p.zero_req | (!r.exceed_ & cpu & mem)) & (r.clash_ == 0);
}

// ServiceAntiAffinity's score on slot n, from the pod's zone histogram
template <typename T, typename Slots>
__device__ __forceinline__ T anti_score(const Pod<T>& p, const Slots& s,
                                        int i) {
  const int zone = s.zone_id(i);
  if (zone < 0) return (T)0;
  if (p.svc_tot <= 0) return (T)10;
  return tenths_below<T>(p.svc_tot, p.zones[zone]);
}

// slot n's contribution to the pod's zone histogram `zones`: its service
// count where it fits and carries the zone label
template <typename T, typename Slots>
__device__ __forceinline__ void add_zone(const Params<T>& a,
                                         const Pod<T>& p, const Slots& s,
                                         int i, int n, int* zones) {
  const int zone = s.zone_id(i);
  if (zone >= 0) {
    const int g = p.svc_group > 0 ? p.svc_group : 0;
    atomicAdd(zones + zone, a.svc_count[(size_t)g * a.N + n]);
  }
}

__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(~0u, v);
}

// the block's largest value, returned to every thread
__device__ int block_max(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_max(lane < (int)(blockDim.x >> 5) ? red[lane] : INT_MIN);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// The cluster's reductions, shared by K1 and K5: each CTA has published
// its partial (a group max in `slot`, a zone histogram in `zl`) in its
// own shared memory before a cluster barrier; these read every CTA's
// over distributed shared memory. Max and integer sums are exact in any
// order.
__device__ __forceinline__ int cluster_read_max(cg::cluster_group& cl,
                                                int* slot) {
  const int lane = threadIdx.x & 31;
  return warp_max(lane < (int)cl.num_blocks()
                      ? *cl.map_shared_rank(slot, lane) : INT_MIN);
}

// the cluster's zone histogram into `ztot` (this CTA's shared memory),
// complete for every thread of the CTA on return
__device__ __forceinline__ void cluster_sum_zones(cg::cluster_group& cl,
                                                  int* zl, int* ztot,
                                                  int Z) {
  const int C = (int)cl.num_blocks();
  for (int z = threadIdx.x; z < Z; z += blockDim.x) {
    int sum = 0;
    for (int r = 0; r < C; ++r) sum += cl.map_shared_rank(zl, r)[z];
    ztot[z] = sum;
  }
  __syncthreads();
}

// (c, j) beats (d, i): the larger composite, then the smaller slot
template <typename T>
__device__ __forceinline__ bool beats(T c, int j, T d, int i) {
  return c > d || (c == d && j < i);
}

// the warp's best (composite, slot) in every lane, as beats() orders
// them: the largest composite, then the smallest slot holding it (a
// 64-bit composite compared by its signed high and unsigned low words)
template <typename T>
__device__ __forceinline__ void warp_best(T& c, int& j) {
  long long m;
  if (sizeof(T) == 4) {
    m = __reduce_max_sync(~0u, (int)c);
  } else {
    const long long v = (long long)c;
    const int hi = __reduce_max_sync(~0u, (int)(v >> 32));
    const unsigned lo = __reduce_max_sync(
        ~0u, (int)(v >> 32) == hi ? (unsigned)v : 0u);
    m = (long long)(((unsigned long long)(unsigned)hi << 32) | lo);
  }
  j = __reduce_min_sync(~0u, (long long)c == m ? j : INT_MAX);
  c = (T)m;
}

// offer slot n to this thread's running best: only fitting slots with a
// non-negative composite can be picked (engine: fit_any = best >= 0)
template <typename T>
__device__ __forceinline__ void offer(const Params<T>& a, T total, int tie,
                                      int n, T& best, int& best_j) {
  const T c = wadd(wmul(total, (T)a.N), (T)tie);
  if (c >= 0 && beats(c, n, best, best_j)) { best = c; best_j = n; }
}

// the node-local half of the commit (JAX _commit_node_local) into one
// slot's fields wherever they live (K1: the CTA's shared copy; K6b: the
// slot's record of the block's commits): the pod's requests, count,
// ports and disks
template <typename T>
__device__ __forceinline__ void commit_slot(const Params<T>& a,
                                            const Pod<T>& p, T* cpu_used,
                                            T* mem_used, T* nz_cpu,
                                            T* nz_mem, int* pod_count,
                                            uint32_t* ports, uint32_t* dany,
                                            uint32_t* drw) {
  *cpu_used = wadd(*cpu_used, p.req_cpu);
  *mem_used = wadd(*mem_used, p.req_mem);
  *nz_cpu = wadd(*nz_cpu, p.nz_cpu);
  *nz_mem = wadd(*nz_mem, p.nz_mem);
  *pod_count += 1;
  for (int w = 0; w < a.PW; ++w) ports[w] |= p.words[a.L + w];
  for (int w = 0; w < a.K; ++w) {
    dany[w] |= p.words[a.L + a.PW + 2 * a.K + w];
    drw[w] |= p.words[a.L + a.PW + 3 * a.K + w];
  }
}

struct __align__(16) Cand {
  long long c;
  int j;
};

// K1's candidate exchange. Each CTA holds an inbox of C records and two
// barriers (by exchange parity). A CTA's warp 0 writes its best into
// every CTA's inbox with st.async, which counts the record's bytes off
// that CTA's barrier when they land (complete_tx, release at cluster
// scope); a barrier's phase completes when its CTA has armed it with
// the C records' bytes (one arrival) and they have all landed. Every
// thread waits on its own CTA's barrier (acquire) and reads the C
// records locally; thread 0 then arms the barrier for its next phase.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// arm `bar` for its current phase: the one arrival, `bytes` to land
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// record (c, j) into `slot` of CTA `dst`, counted off its `bar`
__device__ __forceinline__ void push_best(Cand* slot, uint64_t* bar, int dst,
                                          long long c, int j) {
  uint32_t rs, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rs) : "r"(smem_addr(slot)), "r"(dst));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(rb) : "r"(smem_addr(bar)), "r"(dst));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(rs), "r"((int)c), "r"((int)(c >> 32)), "r"(j), "r"(0),
         "r"(rb) : "memory");
}

// wait until the phase of `bar` with parity `phase` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
}

// K7: the shards' exchange in the sharded K1. S shards (clusters) walk
// the same pods; for each reduction a pod needs across the node axis,
// each shard's CTA 0 posts one record into a buffer in global memory
// and every CTA reads all S records and reduces them alike, so every
// shard reaches the same group max, zone histogram and winner. A
// record's payload is written first (relaxed) and its sequence number
// last (release); a reader spins on the sequence (acquire), then reads
// the payload (relaxed, past L1). The sequence is the launch's
// generation (the buffer's header, which shard 0 advances once every
// shard has posted its done record) in the high word and the
// exchange's count (by kind) in the low one, so the buffer is zeroed
// once and never reset. Two records a shard and kind, by the count's
// parity: a shard cannot post count m + 2 before every shard has read
// count m, since posting m + 1 needs every CTA of its own shard past
// reading m (a cluster barrier or its inbox lies between) and posting
// m + 2 needs every shard's m + 1. Scope .gpu: the shards share one
// card. A spin that outlasts the budget traps, so a lost record raises
// in the caller.
// Layout in int64 words (scan_kernel.exchange_words): a header of 16
// (word 0 the generation), a done record a shard, then by [parity]
// [shard] the candidates (sequence, composite, slot, pad), the group
// maxima (sequence, max) and the zone histograms (sequence, Z int32 in
// ceil(Z / 2) words).
struct K7 {
  unsigned long long* base;
  int S, shard, zw;
  long long budget;
  unsigned long long gen;     // this launch's, in the high word

  __device__ unsigned long long* done(int r) const { return base + 16 + r; }
  __device__ unsigned long long* cand(int par, int r) const {
    return base + 16 + S + 4 * (par * S + r);
  }
  __device__ unsigned long long* gmax(int par, int r) const {
    return base + 16 + 9 * S + 2 * (par * S + r);
  }
  __device__ unsigned long long* zone(int par, int r) const {
    return base + 16 + 13 * S + (size_t)(1 + zw) * (par * S + r);
  }
  __device__ unsigned long long seq(int m) const {
    return gen | (unsigned long long)(unsigned)(m + 1);
  }
};

__device__ __forceinline__ uint64_t gaddr(const void* p) {
  return (uint64_t)__cvta_generic_to_global(p);
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

__device__ __forceinline__ void st_relaxed64(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(gaddr(p)), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(gaddr(p)) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed32(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;"
               :: "l"(gaddr(p)), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_relaxed32(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(gaddr(p)) : "memory");
  return v;
}

// wait for record `p` to carry sequence `want`; trap past the budget
__device__ __forceinline__ void k7_wait(const unsigned long long* p,
                                       unsigned long long want,
                                       const K7& x) {
  const long long t0 = clock64();
  while (ld_acquire(p) != want)
    if (clock64() - t0 > x.budget) __trap();
}

// the shards' largest group count, from this shard's `m` (every thread
// of the CTA calls it; CTA 0's thread 0 posts). -> the max in every
// thread, through `slot` (this CTA's shared memory, by parity)
__device__ __forceinline__ int k7_max(const K7& x, int m, int count,
                                      bool poster, int* slot) {
  const int par = count & 1, lane = threadIdx.x & 31;
  if (poster) {
    unsigned long long* r = x.gmax(par, x.shard);
    st_relaxed64(r + 1, (unsigned long long)(unsigned)m);
    st_release(r, x.seq(count));
  }
  if ((threadIdx.x >> 5) == 0) {
    int v = INT_MIN;
    if (lane < x.S) {
      const unsigned long long* r = x.gmax(par, lane);
      k7_wait(r, x.seq(count), x);
      v = (int)(unsigned)ld_relaxed64(r + 1);
    }
    v = warp_max(v);
    if (lane == 0) slot[par] = v;
  }
  __syncthreads();
  return slot[par];
}

// the shards' zone histogram into `ztot` (this CTA's shard's sums on
// entry, complete for every thread of the CTA on return); CTA 0 posts
__device__ __forceinline__ void k7_zones(const K7& x, int* ztot, int Z,
                                         int count, bool cta0) {
  const int par = count & 1, lane = threadIdx.x & 31;
  if (cta0) {
    int* w = (int*)(x.zone(par, x.shard) + 1);
    for (int z = threadIdx.x; z < Z; z += blockDim.x)
      st_relaxed32(w + z, ztot[z]);
    __threadfence();
  }
  __syncthreads();
  if (cta0 && threadIdx.x == 0)
    st_release(x.zone(par, x.shard), x.seq(count));
  if ((threadIdx.x >> 5) == 0 && lane < x.S) {
    k7_wait(x.zone(par, lane), x.seq(count), x);
    __threadfence();
  }
  __syncthreads();
  for (int z = threadIdx.x; z < Z; z += blockDim.x) {
    int sum = 0;
    for (int r = 0; r < x.S; ++r)
      sum += ld_relaxed32((const int*)(x.zone(par, r) + 1) + z);
    ztot[z] = sum;
  }
  __syncthreads();
}

// the shards' best (composite, slot) from this shard's (c, j), reduced
// as beats() orders them; `poster` (CTA 0's thread 0) posts unless it
// withholds. -> in every thread, through `slot_c` / `slot_j`
template <typename T>
__device__ __forceinline__ void k7_best(const K7& x, T& c, int& j,
                                        int count, bool poster,
                                        bool withhold, long long* slot_c,
                                        int* slot_j) {
  const int par = count & 1, lane = threadIdx.x & 31;
  if (poster && !withhold) {
    unsigned long long* r = x.cand(par, x.shard);
    st_relaxed64(r + 1, (unsigned long long)(long long)c);
    st_relaxed64(r + 2, (unsigned long long)(unsigned)j);
    st_release(r, x.seq(count));
  }
  if ((threadIdx.x >> 5) == 0) {
    T rc = (T)-1;
    int rj = INT_MAX;
    if (lane < x.S) {
      const unsigned long long* r = x.cand(par, lane);
      k7_wait(r, x.seq(count), x);
      rc = (T)(long long)ld_relaxed64(r + 1);
      rj = (int)(unsigned)ld_relaxed64(r + 2);
    }
    warp_best(rc, rj);
    if (lane == 0) { slot_c[par] = (long long)rc; slot_j[par] = rj; }
  }
  __syncthreads();
  c = (T)slot_c[par];
  j = slot_j[par];
}

// K1's body, unsharded (SHARDED false: one cluster over the whole node
// axis) or as shard `shard` of a mesh (one cluster over the shard's
// block, with the K7 exchanges after each cluster reduction and `a`'s
// replicated counts the shard's own copy)
template <typename T, bool HAS_SPREAD, bool HAS_AFF, bool ANTI, bool SHARDED>
__device__ __forceinline__ void scan_body(const Params<T>& a, int shard) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Cand inbox[2][SCAN_MAX_CLUSTER];  // the CTAs' best, by parity
  __shared__ __align__(8) uint64_t inbox_bar[2];
  __shared__ int gmax[2];           // its group max, by exchange parity
  __shared__ long long red_c[32];
  __shared__ int red_j[32];
  __shared__ int red_m[33];
  // K7's results, by exchange parity
  __shared__ long long xs_c[SHARDED ? 2 : 1];
  __shared__ int xs_j[SHARDED ? 2 : 1];
  __shared__ int xs_m[SHARDED ? 2 : 1];
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  // warps 0 .. nwarps - 2 own the slots; the last stages the pod rows
  const int nscore = nthreads - 32;
  const int first = (int)threadIdx.x < nscore ? (int)threadIdx.x : INT_MAX;
  const bool loader = warp == nwarps - 1;
  // the cluster's slots: the whole axis, or the shard's block
  const int span = SHARDED ? a.shard_block : a.N;
  const int S = (span + C - 1) / C;
  const int lo = (SHARDED ? shard * a.shard_block : 0) + rank * S;
  const int ns = max(0, min(span - rank * S, S));
  const int E = pod_words<T, HAS_SPREAD, HAS_AFF, ANTI>(a);
  // the CTA that writes the assignment and posts the shard's records
  const bool head = rank == 0 && (!SHARDED || shard == 0);
  K7 x;
  if constexpr (SHARDED) {
    x.base = a.xchg;
    x.S = a.shards;
    x.shard = shard;
    x.zw = (a.Z + 1) / 2;
    x.budget = a.budget > 0 ? a.budget : K7_BUDGET;
    x.gen = (ld_relaxed64(a.xchg) + 1) << 32;
  }
  const bool poster = SHARDED && rank == 0 && threadIdx.x == 0;

  SharedSlots<T> s;
  uint32_t* ring = (uint32_t*)carve(s, smem, S, a.L, a.PW, a.K);
  int* zloc = (int*)(ring + 3 * E);   // [2][Z] this CTA's zone partials
  int* ztot = zloc + 2 * a.Z;         // [Z] the cluster's sums
  s.flags_ = (uint8_t*)(ztot + a.Z);

  // the owner of each slot copies it in
  for (int i = first; i < ns; i += nscore) load_slot(a, s, i, lo + i);
  if (ANTI)
    for (int z = threadIdx.x; z < 2 * a.Z; z += nthreads) zloc[z] = 0;
  for (int e = threadIdx.x; e < E; e += nthreads)
    ring[e] = pod_word<T, HAS_SPREAD, HAS_AFF, ANTI>(a, 0, e);
  if (threadIdx.x == 0) {
    for (int q = 0; q < 2; ++q) {
      bar_init(&inbox_bar[q], 1);
      bar_expect(&inbox_bar[q], C * sizeof(Cand));
    }
    bar_fence_init();
  }
  cl.sync();                        // every CTA has started and staged

  int n_cand = 0, n_max = 0, n_zone = 0;   // exchanges so far, by kind
  for (int k = 0; k < a.P; ++k) {
    uint32_t* next = ring + ((k + 1) % 3) * E;
    Pod<T> p = read_pod<T, HAS_SPREAD, HAS_AFF, ANTI>(a, ring + (k % 3) * E);
    // the loader warp stages pod k + 1's row while the others score pod
    // k; the barrier that ends pod k publishes it
    if (loader && k + 1 < a.P)
      for (int e = lane; e < E; e += 32)
        next[e] = pod_word<T, HAS_SPREAD, HAS_AFF, ANTI>(a, k + 1, e);
    if (!p.valid) {                 // padded pods commit nothing
      if (head && threadIdx.x == 0) a.assigned[k] = -1;
      __syncthreads();
      continue;
    }

    // SelectorSpread: the largest count of the pod's group over every
    // slot, with the group's count on nodes off the table
    if (HAS_SPREAD && p.group_id >= 0) {
      const int* row = a.spread + (size_t)p.gid * a.N + lo;
      int m = INT_MIN;
      for (int i = first; i < ns; i += nscore) m = max(m, row[i]);
      m = block_max(m, red_m);
      if (threadIdx.x == 0) gmax[n_max & 1] = m;
      cl.sync();
      m = cluster_read_max(cl, &gmax[n_max & 1]);
      if constexpr (SHARDED) m = k7_max(x, m, n_max, poster, xs_m);
      p.maxc = max(m, a.offgrid_max[p.gid]);
      ++n_max;
    }

    T best = (T)-1;
    int best_j = INT_MAX;
    if (!ANTI) {
      for (int i = first; i < ns; i += nscore) {
        const int n = lo + i;
        // the total first: its f64 chain runs while the mask resolves
        const T total = node_total<T, HAS_SPREAD>(a, p, s, i, n);
        if (fits<T, HAS_AFF>(a, p, s, i, n))
          offer(a, total, s.tie_rank(i), n, best, best_j);
      }
    } else {
      // ServiceAntiAffinity needs the whole mask first: the zone
      // histogram of this CTA's fitting slots, summed over the cluster
      // (and over the shards)
      int* zl = zloc + (n_zone & 1) * a.Z;
      for (int i = first; i < ns; i += nscore) {
        const int n = lo + i;
        const bool m = fits<T, HAS_AFF>(a, p, s, i, n);
        a.work_mask[n] = m;
        if (m) {
          a.work_total[n] = node_total<T, HAS_SPREAD>(a, p, s, i, n);
          add_zone(a, p, s, i, n, zl);
        }
      }
      cl.sync();
      cluster_sum_zones(cl, zl, ztot, a.Z);
      if constexpr (SHARDED) k7_zones(x, ztot, a.Z, n_zone, rank == 0);
      p.zones = ztot;
      for (int i = first; i < ns; i += nscore) {
        const int n = lo + i;
        if (a.work_mask[n])
          offer(a, wadd(a.work_total[n], wmul(a.w_anti, anti_score(p, s, i))),
                s.tie_rank(i), n, best, best_j);
      }
    }

    // the CTA's best into every CTA's inbox, then the cluster's
    warp_best(best, best_j);
    if (lane == 0) { red_c[warp] = (long long)best; red_j[warp] = best_j; }
    __syncthreads();
    const int b = n_cand & 1;
    if (warp == 0) {
      T c = lane < nwarps ? (T)red_c[lane] : (T)-1;
      int j = lane < nwarps ? red_j[lane] : INT_MAX;
      warp_best(c, j);
      if (lane < C) push_best(&inbox[b][rank], &inbox_bar[b], lane, c, j);
    }
    bar_wait(&inbox_bar[b], (n_cand >> 1) & 1);
    if (threadIdx.x == 0) bar_expect(&inbox_bar[b], C * sizeof(Cand));
    {
      T c = (T)-1;
      int j = INT_MAX;
      if (lane < C) {
        c = (T)inbox[b][lane].c;
        j = inbox[b][lane].j;
      }
      warp_best(c, j);
      best = c;
      best_j = j;
    }
    if constexpr (SHARDED)
      k7_best(x, best, best_j, n_cand, poster,
              a.withhold == shard && n_cand == 0, xs_c, xs_j);
    ++n_cand;
    if (ANTI)   // every CTA read this use's partials before it pushed
      for (int z = threadIdx.x; z < a.Z; z += nthreads)
        zloc[(n_zone & 1) * a.Z + z] = 0;
    if (ANTI) ++n_zone;

    if (best >= 0) {
      const int j = best_j, i = j - lo;
      if (i >= 0 && i < ns && (int)threadIdx.x == i % nscore) {
        // the owner commits into its copy and its slot's columns
        commit_slot(a, p, &s.cpu_used_[i], &s.mem_used_[i], &s.nz_cpu_[i],
                    &s.nz_mem_[i], &s.pod_count_[i], &s.ports_[i * a.PW],
                    &s.dany_[i * a.K], &s.drw_[i * a.K]);
        if (HAS_SPREAD)
          for (int g = 0; g < a.G; ++g)
            a.spread[(size_t)g * a.N + j] += p.member[g];
        if (ANTI)
          for (int g = 0; g < a.S; ++g)
            a.svc_count[(size_t)g * a.N + j] += p.svc_member[g];
      }
      if ((HAS_AFF || ANTI) && rank == 0) {
        // the counts every CTA reads: CTA 0 commits them (each shard's
        // CTA 0 into the shard's own copy)
        if (HAS_AFF)
          for (int t = threadIdx.x; t < a.NT; t += nthreads) {
            const int add = p.terms[2 * a.NT + t];
            const int dom = a.aff_dom[(size_t)t * a.N + j];
            if (dom >= 0) a.aff_count[(size_t)t * a.D + dom] += add;
            a.aff_total[t] += add;
          }
        if (ANTI)
          for (int g = threadIdx.x; g < a.S; g += nthreads)
            a.svc_total[g] += p.svc_member[g];
      }
    }
    if (head && threadIdx.x == 0) a.assigned[k] = best >= 0 ? best_j : -1;
    if ((HAS_AFF || ANTI) && best >= 0) cl.sync();   // publish CTA 0's
  }

  // the State back, once
  for (int i = first; i < ns; i += nscore) store_slot(a, s, i, lo + i);
  cl.sync();                        // no CTA leaves while read remotely
  if constexpr (SHARDED) {
    // done: shard 0 advances the generation once every shard is past
    // its last read of the buffer (and of its header)
    if (poster) {
      st_release(x.done(shard), x.gen);
      if (shard == 0) {
        for (int r = 0; r < x.S; ++r) k7_wait(x.done(r), x.gen, x);
        st_relaxed64(a.xchg, x.gen >> 32);
      }
    }
  }
}

template <typename T, bool HAS_SPREAD, bool HAS_AFF, bool ANTI>
__global__ void __launch_bounds__(SCAN_BLOCK_THREADS, 1)
scan_kernel(const Params<T> a) {
  scan_body<T, HAS_SPREAD, HAS_AFF, ANTI, false>(a, 0);
}

// the sharded K1: a cluster a shard, the grid's clusters shards 0, 1,
// ...; shard k > 0 reads and commits the replicated counts in its own
// row of `replica`, copied from the State's (shard 0's) at the start:
// shard 0 commits nothing before every shard has posted its first
// record, which it does after its copy
template <typename T, bool HAS_SPREAD, bool HAS_AFF, bool ANTI>
__global__ void __launch_bounds__(SCAN_BLOCK_THREADS, 1)
scan_sharded_kernel(const Params<T> a0) {
  cg::cluster_group cl = cg::this_cluster();
  const int shard = (int)(blockIdx.x / cl.num_blocks());
  Params<T> a = a0;
  if (shard > 0) {
    const int td = a0.NT * a0.D;
    int* row = a0.replica + (size_t)(shard - 1) * (td + a0.NT + a0.S);
    a.aff_count = row;
    a.aff_total = row + td;
    a.svc_total = row + td + a0.NT;
    if (cl.block_rank() == 0) {
      // the body's first cluster barrier publishes the copy
      for (int i = threadIdx.x; i < td; i += blockDim.x)
        row[i] = a0.aff_count[i];
      for (int i = threadIdx.x; i < a0.NT; i += blockDim.x)
        row[td + i] = a0.aff_total[i];
      for (int i = threadIdx.x; i < a0.S; i += blockDim.x)
        row[td + a0.NT + i] = a0.svc_total[i];
    }
  }
  scan_body<T, HAS_SPREAD, HAS_AFF, ANTI, true>(a, shard);
}

// K5, one block a pod (the batch shape): the group max first, then the
// mask and totals, and with ANTI a second pass once the zone histogram
// of the fitting slots is complete. A slot's total is computed before
// its mask (its f64 chain runs while the mask resolves, as in K1), and
// the int64 instantiation with affinity and ANTI is bound to two blocks
// an SM: of the orders and bounds kubemark/profile_kernels.py builds,
// the fastest in each instantiation under which ptxas spills nothing
// (PERF.md section 6).
template <typename T, bool HAS_AFF, bool ANTI>
__device__ __forceinline__ void probe_block(const Params<T>& a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int red_max[33];
  const int k = blockIdx.x;
  const int E = pod_words<T, true, HAS_AFF, ANTI>(a);
  uint32_t* row = (uint32_t*)smem;
  int* zones = (int*)(row + E);
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    row[e] = pod_word<T, true, HAS_AFF, ANTI>(a, k, e);
  if (ANTI)
    for (int z = threadIdx.x; z < a.Z; z += blockDim.x) zones[z] = 0;
  __syncthreads();
  Pod<T> p = read_pod<T, true, HAS_AFF, ANTI>(a, row);
  p.zones = zones;
  if (p.group_id >= 0) {
    const int* srow = a.spread + (size_t)p.gid * a.N;
    int m = INT_MIN;
    for (int n = threadIdx.x; n < a.N; n += blockDim.x) m = max(m, srow[n]);
    p.maxc = max(block_max(m, red_max), a.offgrid_max[p.gid]);
  }
  const GlobalSlots<T> s{a};
  uint8_t* mask = a.mask + (size_t)k * a.N;
  T* total = a.total + (size_t)k * a.N;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    const T t = node_total<T, true>(a, p, s, n, n);
    const bool m = fits<T, HAS_AFF>(a, p, s, n, n);
    mask[n] = m;
    total[n] = t;
    if (ANTI && m) add_zone(a, p, s, n, n, zones);
  }
  if (ANTI) {
    __syncthreads();
    for (int n = threadIdx.x; n < a.N; n += blockDim.x)
      total[n] = wadd(total[n], wmul(a.w_anti, anti_score(p, s, n)));
  }
}

template <typename T, bool HAS_AFF, bool ANTI>
__global__ void __launch_bounds__(PROBE_BLOCK_THREADS)
probe_kernel(const Params<T> a) {
  probe_block<T, HAS_AFF, ANTI>(a);
}

// the same at two blocks an SM (the int64 instantiation with affinity
// and ANTI)
template <typename T, bool HAS_AFF, bool ANTI>
__global__ void __launch_bounds__(PROBE_BLOCK_THREADS, 2)
probe_kernel_2(const Params<T> a) {
  probe_block<T, HAS_AFF, ANTI>(a);
}

// K6a: the speculative pass over pods [k0, k0 + count), a block a pod:
// the pod's composites against the block-start State (K5's body, into
// shared memory), then its top list. Pod q of the block needs only its
// K = min(q + 1, count) largest fitting composites (at most q slots are
// touched when it is repaired, and composites are injective per slot,
// so its largest untouched fitting slot ranks among them). They are
// selected in a time that does not grow with q: a radix select, 8 bits
// a pass from the highest bit any composite sets, finds the K-th
// largest key (the composite, then the slot, smaller first, as beats()
// orders them: the slot digits are read only where composites tie),
// each pass a histogram of the keys still matching the digits chosen
// so far (a shared atomic a digit a warp) and one warp's scan of it,
// stopping once the chosen digit's bin holds exactly the entries still
// wanted; the selected entries are compacted and each is put at its
// rank (the selected entries that beat it). The grid runs the pods of
// the block backwards (CTA c takes pod count - 1 - c), so the CTAs with
// the longest lists start first. Row q of `total` and `spec_nodes` ([count]
// each) gets the K composites and slots, largest first, -1 past them
// and past the fitting slots (spec_kernel.spec_top_plain).
// The composites are K5's block-a-pod body (probe_block) for pod k0 + q
// with no affinity and no ANTI, the spread tier as the run has it,
// written as where(mask, total * N + tie_rank, -1) into shared memory:
// the same helpers (read_pod, block_max, node_total, fits), in a
// function of its own so that K5's instantiations compile as they did
// (a template shared with K5 cost K5's node-local int32 instantiation
// two registers and so a block an SM, PERF.md section 6).
#define SPEC_TOP_MAX 256   // the longest top list: SPEC_BLOCK

template <typename T, bool HAS_SPREAD>
__device__ __forceinline__ void spec_pass_block(const Params<T>& a, int k0,
                                                int count) {
  using U = typename std::make_unsigned<T>::type;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int red_max[33];
  __shared__ int red_n[32];
  __shared__ unsigned red_or[2][32];
  // the radix state: the digits chosen (prefix under mask, the slot
  // digits' under smask), the entries still wanted, done
  __shared__ U s_prefix, s_mask;
  __shared__ int s_sprefix, s_smask, s_left, s_done, s_sel;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = count - 1 - (int)blockIdx.x;
  const int E = pod_words<T, HAS_SPREAD, false, false>(a);
  uint32_t* row = (uint32_t*)smem;
  // spec_kernel.pass_bytes: the pod's row, its N composites, the
  // selected entries, the histogram
  T* vals = (T*)(smem + (((size_t)4 * E + 7) & ~(size_t)7));   // [N]
  T* sel_c = vals + a.N;                                        // [256]
  int* sel_n = (int*)(sel_c + SPEC_TOP_MAX);                    // [256]
  int* hist = sel_n + SPEC_TOP_MAX;                             // [256]
  for (int e = threadIdx.x; e < E; e += nthreads)
    row[e] = pod_word<T, HAS_SPREAD, false, false>(a, k0 + q, e);
  for (int i = threadIdx.x; i < 256; i += nthreads) hist[i] = 0;
  __syncthreads();
  Pod<T> p = read_pod<T, HAS_SPREAD, false, false>(a, row);
  if (HAS_SPREAD && p.group_id >= 0) {
    const int* srow = a.spread + (size_t)p.gid * a.N;
    int m = INT_MIN;
    for (int n = threadIdx.x; n < a.N; n += nthreads) m = max(m, srow[n]);
    p.maxc = max(block_max(m, red_max), a.offgrid_max[p.gid]);
  }
  const GlobalSlots<T> s{a};
  int fit = 0;
  U bits = 0;
  for (int n = threadIdx.x; n < a.N; n += nthreads) {
    const T t = node_total<T, HAS_SPREAD>(a, p, s, n, n);
    const T v = fits<T, false>(a, p, s, n, n)
                    ? wadd(wmul(t, (T)a.N), (T)s.tie_rank(n)) : (T)-1;
    vals[n] = v;
    if (v >= 0) {
      ++fit;
      bits |= (U)v;
    }
  }
  // the fitting slots and the bits their composites set
  fit = __reduce_add_sync(~0u, fit);
  const unsigned lo = __reduce_or_sync(~0u, (unsigned)bits);
  const unsigned hi = sizeof(T) == 8
      ? __reduce_or_sync(~0u, (unsigned)((unsigned long long)bits >> 32))
      : 0u;
  if (lane == 0) {
    red_n[warp] = fit;
    red_or[0][warp] = lo;
    red_or[1][warp] = hi;
  }
  if (threadIdx.x == 0) {
    s_prefix = 0;
    s_mask = 0;
    s_sprefix = 0;
    s_smask = 0;
    s_sel = 0;
  }
  __syncthreads();
  int M = 0;
  unsigned long long any = 0;
  for (int w = 0; w < nwarps; ++w) {
    M += red_n[w];
    any |= ((unsigned long long)red_or[1][w] << 32) | red_or[0][w];
  }
  const int K = min(q + 1, count);
  if (M > K) {
    // radix select of the K-th largest key: the composite's digits from
    // the highest set bit down, then the slot's (N - 1 - n, two digits),
    // where composites tie
    const int top = 63 - __clzll((long long)any);   // any > 0: M > 0
    int left = K;
    for (int level = top / 8 + 2; level >= 0; --level) {
      const bool slot_level = level < 2;
      const int shift = slot_level ? 8 * level : 8 * (level - 2);
      const U prefix = s_prefix, mask = s_mask;
      const int sprefix = s_sprefix, smask = s_smask;
      for (int base = 0; base < a.N; base += nthreads) {
        // one atomic a digit a warp: the lanes holding it counted
        const int n = base + threadIdx.x;
        int digit = -1;
        if (n < a.N) {
          const T v = vals[n];
          const int key2 = a.N - 1 - n;
          if (v >= 0 && ((U)v & mask) == prefix
              && (key2 & smask) == sprefix)
            digit = slot_level ? (key2 >> shift) & 255
                               : (int)(((U)v >> shift) & 255);
        }
        const unsigned same = __match_any_sync(~0u, digit);
        if (digit >= 0 && lane == __ffs(same) - 1)
          atomicAdd(&hist[digit], __popc(same));
      }
      __syncthreads();
      if (warp == 0) {
        // lane l holds bins 255 - 8l .. 248 - 8l, the largest digit first
        int h[8], sum = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          h[i] = hist[255 - 8 * lane - i];
          hist[255 - 8 * lane - i] = 0;
          sum += h[i];
        }
        int cum = sum;   // inclusive scan over the lanes
        for (int o = 1; o < 32; o <<= 1) {
          const int x = __shfl_up_sync(~0u, cum, o);
          if (lane >= o) cum += x;
        }
        const unsigned hit = __ballot_sync(~0u, cum >= left);
        const int src = __ffs(hit) - 1;
        if (lane == src) {
          // the bin the wanted entry falls in (constant indices: h stays
          // in registers)
          int above = cum - sum, i = -1, hi = 0;
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            if (i < 0 && above + h[t] >= left) {
              i = t;
              hi = h[t];
            } else if (i < 0) {
              above += h[t];
            }
          }
          const int d = 255 - 8 * lane - i;
          const int want = left - above;
          if (slot_level) {
            s_sprefix = sprefix | (d << shift);
            s_smask = smask | (255 << shift);
          } else {
            s_prefix = prefix | ((U)d << shift);
            s_mask = mask | ((U)255 << shift);
          }
          s_left = want;
          s_done = hi == want;
        }
      }
      __syncthreads();
      left = s_left;
      if (s_done) break;
    }
  }
  // the selected entries: above the chosen digits, or on them
  {
    const U prefix = s_prefix, mask = s_mask;
    const int sprefix = s_sprefix, smask = s_smask;
    for (int n = threadIdx.x; n < a.N; n += nthreads) {
      const T v = vals[n];
      if (v < 0) continue;
      const U m = (U)v & mask;
      if (m > prefix || (m == prefix && ((a.N - 1 - n) & smask) >= sprefix)) {
        const int at = atomicAdd(&s_sel, 1);
        sel_c[at] = v;
        sel_n[at] = n;
      }
    }
  }
  __syncthreads();
  // each entry at its rank: two threads an entry, each counting half
  const int S = s_sel;
  T* out_c = a.total + (size_t)q * count;
  int* out_n = a.spec_nodes + (size_t)q * count;
  for (int base = 0; base < S; base += nthreads >> 1) {
    const int e = base + (threadIdx.x >> 1), half = threadIdx.x & 1;
    T c = (T)-1;
    int j = INT_MAX, rank = 0;
    if (e < S) {
      c = sel_c[e];
      j = sel_n[e];
      for (int x = half; x < S; x += 2)
        rank += beats(sel_c[x], sel_n[x], c, j);
    }
    rank += __shfl_xor_sync(~0u, rank, 1);
    if (e < S && half == 0) {
      out_c[rank] = c;
      out_n[rank] = j;
    }
  }
  for (int r = S + threadIdx.x; r < count; r += nthreads) {
    out_c[r] = (T)-1;
    out_n[r] = -1;
  }
}

template <typename T, bool HAS_SPREAD>
__global__ void __launch_bounds__(PROBE_BLOCK_THREADS)
spec_pass_kernel(const Params<T> a, int k0, int count) {
  spec_pass_block<T, HAS_SPREAD>(a, k0, count);
}

// the same at one block an SM (the int64 instantiation on the spread
// tier, which spills at two blocks' 64 registers; off the timed paths:
// the e2e chunk and the engine fixtures narrow to int32)
template <typename T, bool HAS_SPREAD>
__global__ void __launch_bounds__(PROBE_BLOCK_THREADS, 1)
spec_pass_kernel_1(const Params<T> a, int k0, int count) {
  spec_pass_block<T, HAS_SPREAD>(a, k0, count);
}

// record i of `src` into `dst`, the lanes of a warp over its words
template <typename T>
__device__ __forceinline__ void copy_record(const Params<T>& a,
                                            Deltas<T>& dst,
                                            const Deltas<T>& src, int i,
                                            int lane) {
  if (lane == 0) {
    dst.cpu_used[i] = src.cpu_used[i];
    dst.mem_used[i] = src.mem_used[i];
    dst.nz_cpu[i] = src.nz_cpu[i];
    dst.nz_mem[i] = src.nz_mem[i];
    dst.pod_count[i] = src.pod_count[i];
  }
  for (int w = lane; w < a.PW; w += 32)
    dst.ports[i * a.PW + w] = src.ports[i * a.PW + w];
  for (int w = lane; w < a.K; w += 32) {
    dst.dany[i * a.K + w] = src.dany[i * a.K + w];
    dst.drw[i * a.K + w] = src.drw[i * a.K + w];
  }
  for (int g = lane; g < dst.groups; g += 32)
    dst.spread[i * dst.groups + g] = src.spread[i * dst.groups + g];
}

// K6b: the speculative repair of pods [k0, k0 + count), one CTA walking
// them in order (JAX _spec_step), as a pipeline one pod deep. Between
// pod k - 1's pick and pod k's, only slot j(k-1) changes, so each of pod
// k's candidates but that one is known once commit k - 2 is in: its
// frozen entries (row k of `total` / `spec_nodes`, K6a's top list) on
// the slots no earlier pod took, and its rescores of the slots pods 0 ..
// k - 2 took. And pod k's score on j(k-1) can be taken before j(k-1) is
// known: j(k-1) is one of the few candidates of pod k - 1's pick, and
// the State there after commit k - 1 is the State before it plus pod
// k - 1's request, whichever it is. Step k runs two roles at once:
//   the chain (warp 0)   pod k: from each producer warp its best less
//                        the entry on j(k-1), the best of those against
//                        pod k's as-if score on j(k-1) -> j(k); its
//                        outputs and the spread latch; the commit, into
//                        the other of two sets of records (below);
//   the producers (the   pod k + 1: its frozen entries on the slots no
//   warps on the other   pod before k took and its rescores of the
//   three schedulers)    slots pods 0 .. k - 1 took (one a thread), each
//                        warp's best two; the last producer warp: pod
//                        k + 1's as-if scores on the candidates of pod
//                        k's pick (every producer warp's two and j(k-1))
//                        with pod k committed there;
// and one __syncthreads publishes commit k and pod k + 1's pairs. The
// producers read slot_of[j(k)] while the chain marks it taken: whatever
// they make of it, the entry on j(k) is the one the chain drops at step
// k + 1, and composites are injective per slot, so each warp's best two
// less one slot hold its best of the rest. So no f64 score is left on
// the chain: it rescores j(k-1) itself only where no as-if score was
// taken (after a pod that took the full width). A slot's State is the
// tables' plus the block's commits to it (Deltas: one record a taken
// slot, in the order they were taken; the record `count` stays zero for
// the others), so a commit is a few adds in shared memory and no load:
// the tables are written once, at the end. The records come in two
// sets: step k reads one (the commits before pod k) while the chain
// makes the other from it, which differs only in commit k - 1's record
// and commit k's, so no reader waits for the commit. Unflagged spread
// pods score with the block-start group max (max_start); a pod whose
// group has latched (a commit lifted a count past max_start; the chain
// decides it for pod k + 1 after the latch of commit k) takes the
// full-width rescore against the live State and the live group max in
// its step, every warp, then the chain commits as usual. Invalid
// (padded) pods commit nothing and write -1; `work_mask`, where given,
// marks the pods that took the full-width rescore.
template <typename T, bool HAS_SPREAD>
__global__ void __launch_bounds__(SPEC_REPAIR_THREADS, 1)
spec_repair_kernel(const Params<T> a, int k0, int count) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ long long red_c[2][32];
  __shared__ int red_j[2][32];
  __shared__ int red_m[33];
  // by the parity of the pod they serve: each producer warp's best two;
  // the as-if scores (pod k's composite on each candidate of pod k - 1's
  // pick, as if pod k - 1 were committed there) and their slots; the
  // records the pods before pod k took; j(k-1); whether pod k takes the
  // full width
  __shared__ long long two_c[2][32][2];
  __shared__ int two_j[2][32][2];
  __shared__ long long asif_c[2][32];
  __shared__ int asif_j[2][32];
  __shared__ int taken_at[2];
  __shared__ int pick_at[2];
  __shared__ int slow_at[2];
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tid = threadIdx.x;
  const int E = pod_words<T, HAS_SPREAD, false, false>(a);
  // spec_kernel.repair_bytes: two sets of count + 1 records (step k
  // reads d0 or d1 by its parity, the commits before pod k, and makes
  // the other from it), the pod rows, two words a group, a slot a
  // record, a record a slot
  Deltas<T> d0, d1;
  uint8_t* end = carve(d0, smem, count + 1, a.PW, a.K, HAS_SPREAD ? a.G : 0);
  end = smem + ((end - smem + 7) & ~(ptrdiff_t)7);   // the T arrays
  end = carve(d1, end, count + 1, a.PW, a.K, HAS_SPREAD ? a.G : 0);
  uint32_t* rows = (uint32_t*)end;                      // [count][E]
  int* max_start = (int*)(rows + (size_t)count * E);   // [G]
  int* flag = max_start + a.G;                          // [G]
  int* node_of = flag + a.G;                            // [count]
  uint16_t* slot_of = (uint16_t*)(node_of + count);     // [N] record + 1
  for (uint32_t* w = (uint32_t*)smem + tid; w < (uint32_t*)end;
       w += nthreads)
    *w = 0;
  // the pod rows, a word of every pod at a time: the lanes read one field
  // of 32 pods (one type, neighbouring addresses) and the loads go out
  // together
  for (int e = warp; e < E; e += nwarps)
    for (int k = lane; k < count; k += 32) {
      bool byte;
      const void* src =
          pod_src<T, HAS_SPREAD, false, false>(a, k0 + k, e, &byte);
      rows[(size_t)k * E + e] = byte ? (uint32_t)*(const uint8_t*)src
                                     : *(const uint32_t*)src;
    }
  for (int n = tid; n < a.N; n += nthreads) slot_of[n] = 0;
  for (int i = tid; i < count; i += nthreads) node_of[i] = -1;
  if (HAS_SPREAD)
    for (int g = 0; g < a.G; ++g) {
      const int* srow = a.spread + (size_t)g * a.N;
      int m = INT_MIN;
      for (int n = tid; n < a.N; n += nthreads) m = max(m, srow[n]);
      m = block_max(m, red_m);
      if (tid == 0) {
        max_start[g] = max(m, a.offgrid_max[g]);
        flag[g] = 0;
      }
    }
  if (tid < 2) {
    taken_at[tid] = 0;
    pick_at[tid] = -1;
    slow_at[tid] = 0;
  }
  for (int i = tid; i < 64; i += nthreads) asif_j[i >> 5][i & 31] = -1;
  // The chain is warp 0, the producers the warps on the SM's other three
  // schedulers (a CTA's warp w issues from scheduler w % 4), so none
  // takes the chain's issue slots; the chain's other warps only meet the
  // barriers.
  // Producer thread pt: list entry pt of the pod it prepares, read one
  // pod ahead, and record pt's rescore; the last producer warp (no entry
  // and no record: spec_dispatch) takes the as-if scores.
  const bool producer = (warp & 3) != 0;
  const int nprod = nwarps - (nwarps + 3) / 4;        // producer warps
  const int pw = warp - 1 - (warp >> 2);              // this one's index
  const int pt = 32 * pw + lane;
  const int ncand = 2 * nprod + 1;                    // a pick's candidates
  T nc = (T)-1;
  int nn = -1;
  if (producer && pt < count) {
    nc = a.total[pt];
    nn = a.spec_nodes[pt];
  }
  int jprev = -1;                   // the chain's j(k - 1)
  int iprev = -1;                   // the record commit k - 1 changed
  int taken = 0;                    // the chain's records in use
  __syncthreads();
  for (int k = -1; k < count; ++k) {
    const int m = k + 1;            // the pod the producers prepare
    const Deltas<T> cur = k & 1 ? d1 : d0;
    bool slow = false;
    Pod<T> p;
    T fb = (T)-1;
    int fj = INT_MAX;
    if (k >= 0) {
      p = read_pod<T, HAS_SPREAD, false, false>(a, rows + (size_t)k * E);
      slow = HAS_SPREAD && slow_at[k & 1];
      if (HAS_SPREAD && slow) {
        // the group max moved since the block start: every slot against
        // the live State and the live group max, every warp
        int mx = INT_MIN;
        for (int n = tid; n < a.N; n += nthreads) {
          const int i = slot_of[n] ? slot_of[n] - 1 : count;
          mx = max(mx, a.spread[(size_t)p.gid * a.N + n]
                           + cur.spread[i * a.G + p.gid]);
        }
        p.maxc = max(block_max(mx, red_m), a.offgrid_max[p.gid]);
        for (int n = tid; n < a.N; n += nthreads) {
          const RegSlot<T> r = reg_slot<T, true>(
              a, p, LiveSlot<T>{a, cur, slot_of[n] ? slot_of[n] - 1 : count,
                                nullptr}, n);
          const T total = node_total<T, true>(a, p, r, n, n);
          if (fits_reg(p, r, n)) offer(a, total, r.tie_rank_, n, fb, fj);
        }
        warp_best(fb, fj);
        if (lane == 0) {
          red_c[k & 1][warp] = (long long)fb;
          red_j[k & 1][warp] = fj;
        }
        __syncthreads();
        fb = lane < nwarps ? (T)red_c[k & 1][lane] : (T)-1;
        fj = lane < nwarps ? red_j[k & 1][lane] : INT_MAX;
        warp_best(fb, fj);
      }
    }
    if (warp == 0) {
      int j = -1, i = -1;
      if (k >= 0) {
        // the chain: pod k's pick
        T best = (T)-1;
        int bj = INT_MAX;
        if (p.valid) {
          if (slow) {
            best = fb;
            bj = fj;
          } else {
            if (HAS_SPREAD && p.group_id >= 0) p.maxc = max_start[p.gid];
            // each producer warp's best less the entry on j(k-1), then
            // the best of those and of pod k's score on j(k-1): the
            // as-if score where one was taken, else its own rescore
            const int par = k & 1;
            if (lane < nprod) {
              const int x = two_j[par][lane][0] == jprev;
              best = (T)two_c[par][lane][x];
              bj = two_j[par][lane][x];
            }
            warp_best(best, bj);
            if (jprev >= 0) {
              const unsigned hit = __ballot_sync(
                  ~0u, lane < ncand && asif_j[par][lane] == jprev);
              T c = (T)-1;
              if (hit) {
                c = (T)asif_c[par][__ffs(hit) - 1];
              } else {
                const RegSlot<T> r = reg_slot<T, HAS_SPREAD>(
                    a, p, LiveSlot<T>{a, cur, slot_of[jprev] - 1, nullptr},
                    jprev);
                const T total = node_total<T, HAS_SPREAD>(a, p, r, jprev,
                                                          jprev);
                if (fits_reg(p, r, jprev))
                  c = wadd(wmul(total, (T)a.N), (T)r.tie_rank_);
              }
              if (c >= 0 && beats(c, jprev, best, bj)) {
                best = c;
                bj = jprev;
              }
            }
          }
        }
        j = best >= 0 ? bj : -1;
        if (j >= 0) {
          // slot j's record (the next free one the first time); the
          // groups whose count the commit lifts past the block-start max
          // latch
          i = (int)slot_of[j] - 1;
          if (i < 0) {
            i = taken++;
            if (lane == 0) {
              slot_of[j] = (uint16_t)(i + 1);
              node_of[i] = j;
            }
          }
          if (HAS_SPREAD)
            for (int g = lane; g < a.G; g += 32) {
              const int add = p.member[g];
              if (add > 0 && a.spread[(size_t)g * a.N + j]
                                 + cur.spread[i * a.G + g] + add
                             > max_start[g])
                flag[g] = 1;
            }
        }
        if (lane == 0) {
          a.assigned[k0 + k] = j;
          if (a.work_mask != nullptr) a.work_mask[k0 + k] = slow;
        }
        jprev = j;
      }
      __syncwarp();
      if (lane == 0) {
        taken_at[m & 1] = taken;
        pick_at[m & 1] = jprev;
        if (HAS_SPREAD && m < count) {
          // whether pod k + 1 takes the full width, after commit k
          const uint32_t* r = rows + (size_t)m * E;
          const int gid = (int)r[3];
          slow_at[m & 1] = r[0] != 0 && gid >= 0 && flag[gid] != 0;
        }
      }
      // the commit into the other set of records, which the producers
      // do not read: it differs from this step's by commit k - 1's record
      // and commit k's
      Deltas<T> nxt = k & 1 ? d0 : d1;
      if (iprev >= 0 && iprev != i) copy_record(a, nxt, cur, iprev, lane);
      if (j >= 0) {
        copy_record(a, nxt, cur, i, lane);
        __syncwarp();
        if (lane == 0)
          commit_slot(a, p, &nxt.cpu_used[i], &nxt.mem_used[i],
                      &nxt.nz_cpu[i], &nxt.nz_mem[i], &nxt.pod_count[i],
                      &nxt.ports[i * a.PW], &nxt.dany[i * a.K],
                      &nxt.drw[i * a.K]);
        if (HAS_SPREAD)
          for (int g = lane; g < a.G; g += 32)
            nxt.spread[i * a.G + g] += p.member[g];
      }
      iprev = i;
    } else if (producer && m < count) {
      // the producers: pod m's candidates as commit k - 1 left them, its
      // frozen entries on the slots no pod before k took and its
      // rescores of the records those pods took; each warp's best two
      Pod<T> q = read_pod<T, HAS_SPREAD, false, false>(
          a, rows + (size_t)m * E);
      if (HAS_SPREAD && q.group_id >= 0) q.maxc = max_start[q.gid];
      T c1 = (T)-1, c2 = (T)-1;
      int j1 = INT_MAX, j2 = INT_MAX;
      if (pt <= m && nc >= 0 && slot_of[nn] == 0) {
        c1 = nc;
        j1 = nn;
      }
      if (pt < taken_at[k & 1]) {
        const int n = node_of[pt];
        const RegSlot<T> r = reg_slot<T, HAS_SPREAD>(
            a, q, LiveSlot<T>{a, cur, pt, nullptr}, n);
        const T total = node_total<T, HAS_SPREAD>(a, q, r, n, n);
        if (fits_reg(q, r, n)) {
          T c = (T)-1;
          int cj = INT_MAX;
          offer(a, total, r.tie_rank_, n, c, cj);
          if (c >= 0) {
            if (beats(c, cj, c1, j1)) {
              c2 = c1; j2 = j1; c1 = c; j1 = cj;
            } else {
              c2 = c; j2 = cj;
            }
          }
        }
      }
      if (pw == nprod - 1) {
        // pod m's composite on each candidate x of pod k's pick (each
        // producer warp's two, and j(k-1)), as if pod k were committed
        // there: its score on j(k) at step m whatever j(k) turns out
        int x = -1;
        if (k >= 0 && p.valid && !slow && lane < ncand)
          x = lane < 2 * nprod ? two_j[k & 1][lane >> 1][lane & 1]
                               : pick_at[k & 1];
        T c = (T)-1;
        if (x >= 0 && x < a.N) {
          const RegSlot<T> r = reg_slot<T, HAS_SPREAD>(
              a, q, LiveSlot<T, true>{a, cur,
                                      slot_of[x] ? slot_of[x] - 1 : count,
                                      &p}, x);
          const T total = node_total<T, HAS_SPREAD>(a, q, r, x, x);
          if (fits_reg(q, r, x))
            c = wadd(wmul(total, (T)a.N), (T)r.tie_rank_);
        } else {
          x = -1;
        }
        if (lane < ncand) {
          asif_c[m & 1][lane] = (long long)c;
          asif_j[m & 1][lane] = x;
        }
      }
      // list entry pt of pod m + 1, for the next step
      if (pt < count && m + 1 < count) {
        nc = a.total[(size_t)(m + 1) * count + pt];
        nn = a.spec_nodes[(size_t)(m + 1) * count + pt];
      }
      T b1 = c1;
      int bj1 = j1;
      warp_best(b1, bj1);
      T b2 = j1 == bj1 ? c2 : c1;
      int bj2 = j1 == bj1 ? j2 : j1;
      warp_best(b2, bj2);
      if (lane == 0) {
        two_c[m & 1][pw][0] = (long long)b1;
        two_j[m & 1][pw][0] = bj1;
        two_c[m & 1][pw][1] = (long long)b2;
        two_j[m & 1][pw][1] = bj2;
      }
    }
    __syncthreads();                  // commit k and pod k + 1's pairs
  }
  // the taken slots' State back, once: the tables' plus the records
  const Deltas<T> fin = count & 1 ? d1 : d0;
  for (int i = tid; i < count; i += nthreads) {
    const int n = node_of[i];
    if (n < 0) continue;
    a.cpu_used[n] = wadd(a.cpu_used[n], fin.cpu_used[i]);
    a.mem_used[n] = wadd(a.mem_used[n], fin.mem_used[i]);
    a.nz_cpu[n] = wadd(a.nz_cpu[n], fin.nz_cpu[i]);
    a.nz_mem[n] = wadd(a.nz_mem[n], fin.nz_mem[i]);
    a.pod_count[n] += fin.pod_count[i];
    for (int w = 0; w < a.PW; ++w)
      a.port_bits[(size_t)n * a.PW + w] |= fin.ports[i * a.PW + w];
    for (int w = 0; w < a.K; ++w) {
      a.disk_any[(size_t)n * a.K + w] |= fin.dany[i * a.K + w];
      a.disk_rw[(size_t)n * a.K + w] |= fin.drw[i * a.K + w];
    }
    if (HAS_SPREAD)
      for (int g = 0; g < a.G; ++g)
        a.spread[(size_t)g * a.N + n] += fin.spread[i * a.G + g];
  }
}

// barrier.cluster split in two: this CTA is done reading the others'
// shared memory (arrive), and none of them still reads its own (wait)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// K5 over a cluster (few pods): pod k = blockIdx.x / C on the C CTAs of
// one cluster, CTA r owning slots [r * S, r * S + S), S = ceil(N / C),
// thread t the slots from r * S + t every blockDim.x. Phase 1: its part
// of the spread group's max and, with ANTI, the mask and the zone
// histogram of the fitting slots; the partials reduced over the cluster
// (one barrier, distributed shared memory); phase 2: the totals (and
// without ANTI the mask).
template <typename T, bool HAS_AFF, bool ANTI>
__global__ void __launch_bounds__(PROBE_BLOCK_THREADS, 1)
probe_cluster_kernel(const Params<T> a) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int red_max[33];
  __shared__ int part_max;          // this CTA's part of the group max
  cg::cluster_group cl = cg::this_cluster();
  const int C = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int k = blockIdx.x / C;
  const int S = (a.N + C - 1) / C, lo = rank * S;
  const int ns = max(0, min(a.N - lo, S));
  const int E = pod_words<T, true, HAS_AFF, ANTI>(a);
  uint32_t* row = (uint32_t*)smem;
  int* zones = (int*)(row + E);     // [Z] this CTA's histogram
  int* ztot = zones + a.Z;          // [Z] the pod's
  for (int e = threadIdx.x; e < E; e += blockDim.x)
    row[e] = pod_word<T, true, HAS_AFF, ANTI>(a, k, e);
  if (ANTI)
    for (int z = threadIdx.x; z < a.Z; z += blockDim.x) zones[z] = 0;
  __syncthreads();
  Pod<T> p = read_pod<T, true, HAS_AFF, ANTI>(a, row);
  const GlobalSlots<T> s{a};
  uint8_t* mask = a.mask + (size_t)k * a.N;
  T* total = a.total + (size_t)k * a.N;
  const bool spread = p.group_id >= 0;
  const bool exchange = spread || ANTI;   // the same for the whole pod
  if (exchange) {
    int m = INT_MIN;
    for (int i = threadIdx.x; i < ns; i += blockDim.x) {
      const int n = lo + i;
      if (spread) m = max(m, a.spread[(size_t)p.gid * a.N + n]);
      if (ANTI) {
        const bool f = fits<T, HAS_AFF>(a, p, s, n, n);
        mask[n] = f;
        if (f) add_zone(a, p, s, n, n, zones);
      }
    }
    if (spread) m = block_max(m, red_max);
    if (threadIdx.x == 0) part_max = m;
    cl.sync();                      // every CTA's partials published
    if (spread) p.maxc = max(cluster_read_max(cl, &part_max),
                             a.offgrid_max[p.gid]);
    if (ANTI) cluster_sum_zones(cl, zones, ztot, a.Z);
    cluster_arrive();
  }
  p.zones = ztot;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    const int n = lo + i;
    T t = node_total<T, true>(a, p, s, n, n);
    if (ANTI)
      t = wadd(t, wmul(a.w_anti, anti_score(p, s, n)));
    else
      mask[n] = fits<T, HAS_AFF>(a, p, s, n, n);
    total[n] = t;
  }
  if (exchange) cluster_wait();
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
  a.spec_nodes = P_(PTR_SPEC_NODES, int*);
#undef P_
  a.shards = 0; a.shard_block = 0; a.withhold = -1;
  a.budget = 0; a.xchg = nullptr; a.replica = nullptr;
  return a;
}

// bytes of dynamic shared memory each kernel needs (scan_kernel.py
// shared_bytes): K1 its slots (a cluster over `slots` of them: the
// axis, or a shard's block), the ring of three pod rows and the zone
// partials and sums; K5 one pod row and the zone histogram (on a
// cluster, its CTA's part and the pod's sum)
template <typename T, bool HAS_SPREAD, bool HAS_AFF, bool ANTI>
static long long need_bytes(int kind, const long long* d, int cluster,
                            long long slots) {
  const long long W = sizeof(T) / 4;
  const long long E = 5 + 4 * W + d[DIM_L] + d[DIM_PW] + 4 * d[DIM_K]
                      + (HAS_AFF ? 3 * d[DIM_T] : 0)
                      + (HAS_SPREAD ? d[DIM_G] : 0) + (ANTI ? d[DIM_S] : 0);
  if (kind == 1) return 4 * (E + (cluster > 1 ? 2 : 1) * d[DIM_Z]);
  const long long S = (slots + cluster - 1) / cluster;
  return S * slot_bytes<T>(d[DIM_L], d[DIM_PW], d[DIM_K])
         + 4 * (3 * E + 3 * d[DIM_Z]);
}

// a kernel's attributes, set when a launch first needs them (`*set`:
// the largest dynamic shared memory set so far, -1 before the first
// call), so that a launch captured into a CUDA graph sets nothing
template <typename K>
static cudaError_t set_attributes(K kernel, size_t smem, bool cluster,
                                  long long* set) {
  cudaError_t err = cudaSuccess;
  if (*set < 0 && cluster)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && smem > 48 * 1024 && (long long)smem > *set)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && (long long)smem > *set) *set = (long long)smem;
  return err;
}

static cudaLaunchConfig_t cluster_config(int grid, int cluster, int threads,
                                         size_t smem, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// op 0: launch K1 (one cluster of `cluster` CTAs); op 1: launch K5 (a
// cluster of `cluster` CTAs a pod); ops 2 and 3: the number of K1's, K5's
// clusters of that shape the card can hold at once, into *count (no
// launch); op 4: launch the sharded K1 (a cluster a shard, `sh` its
// shard arguments); op 5: the sharded K1's count, as ops 2 and 3
template <typename T, bool HAS_SPREAD, bool HAS_AFF, bool ANTI>
static cudaError_t dispatch(int op, int cluster, int threads, size_t smem,
                            const long long* dims,
                            const unsigned long long* ptrs,
                            const long long* sh, cudaStream_t stream,
                            int* count) {
  const int kind = op == 1 || op == 3 ? 1 : 0;
  if ((op == 0 || op == 1)
      && (long long)smem < need_bytes<T, HAS_SPREAD, HAS_AFF, ANTI>(
                               kind, dims, cluster, dims[DIM_N]))
    return cudaErrorInvalidValue;
  static long long set[4] = {-1, -1, -1, -1};   // K1's, K5's two, sharded
  cudaError_t err;
  cudaLaunchAttribute attr;
  if (op == 4 || op == 5) {
    auto kernel = scan_sharded_kernel<T, HAS_SPREAD, HAS_AFF, ANTI>;
    err = set_attributes(kernel, smem, true, &set[3]);
    if (err != cudaSuccess) return err;
    if (op == 5) {
      cudaLaunchConfig_t cfg = cluster_config(cluster, cluster, threads,
                                              smem, nullptr, &attr);
      return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
    }
    Params<T> a = unpack<T>(dims, ptrs);
    const long long S = sh[SHARD_SHARDS], B = sh[SHARD_BLOCK];
    const long long zw = (a.Z + 1) / 2;
    if (S < 1 || S > K7_MAX_SHARDS || B < 1 || B * S != a.N
        || sh[SHARD_XCHG] == 0 || (S > 1 && sh[SHARD_REPLICA] == 0)
        || sh[SHARD_XWORDS] < 16 + S + 2 * S * (7 + zw)
        || (long long)smem < need_bytes<T, HAS_SPREAD, HAS_AFF, ANTI>(
                                 0, dims, cluster, B))
      return cudaErrorInvalidValue;
    a.shards = (int)S;
    a.shard_block = (int)B;
    a.budget = sh[SHARD_BUDGET];
    a.withhold = (int)sh[SHARD_WITHHOLD];
    a.xchg = (unsigned long long*)(uintptr_t)sh[SHARD_XCHG];
    a.replica = (int*)(uintptr_t)sh[SHARD_REPLICA];
    cudaLaunchConfig_t cfg = cluster_config((int)S * cluster, cluster,
                                            threads, smem, stream, &attr);
    // a refused launch also leaves its error as the last one: clear it
    err = cudaLaunchKernelEx(&cfg, kernel, (const Params<T>)a);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
  }
  if (kind == 1) {
    if (!HAS_SPREAD) return cudaErrorInvalidValue;   // probes score spread
    if (cluster == 1) {             // one block a pod
      if (op == 3) return cudaErrorInvalidValue;
      void (*kernel)(const Params<T>);
      if constexpr (sizeof(T) == 8 && HAS_AFF && ANTI)
        kernel = probe_kernel_2<T, HAS_AFF, ANTI>;
      else
        kernel = probe_kernel<T, HAS_AFF, ANTI>;
      err = set_attributes(kernel, smem, false, &set[1]);
      if (err != cudaSuccess) return err;
      const Params<T> a = unpack<T>(dims, ptrs);
      kernel<<<a.P, threads, smem, stream>>>(a);
      return cudaGetLastError();
    }
    auto kernel = probe_cluster_kernel<T, HAS_AFF, ANTI>;
    err = set_attributes(kernel, smem, true, &set[2]);
    if (err != cudaSuccess) return err;
    if (op == 3) {
      cudaLaunchConfig_t cfg = cluster_config(cluster, cluster, threads,
                                              smem, nullptr, &attr);
      return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
    }
    const Params<T> a = unpack<T>(dims, ptrs);
    if ((long long)a.P * cluster > INT_MAX) return cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = cluster_config(a.P * cluster, cluster, threads,
                                            smem, stream, &attr);
    // a refused launch also leaves its error as the last one: clear it
    err = cudaLaunchKernelEx(&cfg, kernel, a);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
  }
  auto kernel = scan_kernel<T, HAS_SPREAD, HAS_AFF, ANTI>;
  err = set_attributes(kernel, smem, true, &set[0]);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = cluster_config(cluster, cluster, threads, smem,
                                          stream, &attr);
  if (op == 2) return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
  const Params<T> a = unpack<T>(dims, ptrs);
  // a refused launch also leaves its error as the last one: clear it
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

static int by_variant(int op, int variant, int cluster, int threads,
                      size_t b, const long long* d,
                      const unsigned long long* q, const long long* h,
                      cudaStream_t s, int* n) {
  switch (variant) {
    case 0: return (int)dispatch<int32_t, false, false, false>(op, cluster, threads, b, d, q, h, s, n);
    case 1: return (int)dispatch<int32_t, false, false, true>(op, cluster, threads, b, d, q, h, s, n);
    case 2: return (int)dispatch<int32_t, false, true, false>(op, cluster, threads, b, d, q, h, s, n);
    case 3: return (int)dispatch<int32_t, false, true, true>(op, cluster, threads, b, d, q, h, s, n);
    case 4: return (int)dispatch<int32_t, true, false, false>(op, cluster, threads, b, d, q, h, s, n);
    case 5: return (int)dispatch<int32_t, true, false, true>(op, cluster, threads, b, d, q, h, s, n);
    case 6: return (int)dispatch<int32_t, true, true, false>(op, cluster, threads, b, d, q, h, s, n);
    case 7: return (int)dispatch<int32_t, true, true, true>(op, cluster, threads, b, d, q, h, s, n);
    case 8: return (int)dispatch<int64_t, false, false, false>(op, cluster, threads, b, d, q, h, s, n);
    case 9: return (int)dispatch<int64_t, false, false, true>(op, cluster, threads, b, d, q, h, s, n);
    case 10: return (int)dispatch<int64_t, false, true, false>(op, cluster, threads, b, d, q, h, s, n);
    case 11: return (int)dispatch<int64_t, false, true, true>(op, cluster, threads, b, d, q, h, s, n);
    case 12: return (int)dispatch<int64_t, true, false, false>(op, cluster, threads, b, d, q, h, s, n);
    case 13: return (int)dispatch<int64_t, true, false, true>(op, cluster, threads, b, d, q, h, s, n);
    case 14: return (int)dispatch<int64_t, true, true, false>(op, cluster, threads, b, d, q, h, s, n);
    case 15: return (int)dispatch<int64_t, true, true, true>(op, cluster, threads, b, d, q, h, s, n);
    default: return (int)cudaErrorInvalidValue;
  }
}

// kind 0: K1 over a chunk (one cluster of `cluster` CTAs); kind 1: K5
// (a cluster of `cluster` CTAs a pod, 1: one block a pod). variant: bit 3 the int64 layout,
// bit 2 the spread tier, bit 1 the affinity tier, bit 0
// ServiceAntiAffinity (scan_kernel.launch_plan).
extern "C" int scan_launch(int kind, int variant, int cluster, int threads,
                           long long smem, const long long* dims,
                           const unsigned long long* ptrs, void* stream) {
  if (kind < 0 || kind > 1 || dims[DIM_P] <= 0 || dims[DIM_N] <= 0
      || cluster < 1 || smem < 0 || smem > SCAN_MAX_SHARED_BYTES)
    return (int)cudaErrorInvalidValue;
  return by_variant(kind, variant, cluster, threads, (size_t)smem, dims,
                    ptrs, nullptr, (cudaStream_t)stream, nullptr);
}

// the sharded K1 (K7 inside): clusters of `cluster` CTAs for shards
// shard[SHARD_FIRST] .. + shard[SHARD_RUN] - 1 of a mesh of
// shard[SHARD_SHARDS] (enum ShardArg); variant as scan_launch's. Every
// shard's cluster must be resident at once: scan_max_clusters with bit
// 5 of its variant set says how many the card holds
// (scan_kernel.launch_plan(..., shards=) checks before it launches).
extern "C" int shard_launch(int variant, int cluster, int threads,
                            long long smem, const long long* dims,
                            const unsigned long long* ptrs,
                            const long long* shard, void* stream) {
  if (dims[DIM_P] <= 0 || dims[DIM_N] <= 0 || cluster < 1 || smem < 0
      || smem > SCAN_MAX_SHARED_BYTES)
    return (int)cudaErrorInvalidValue;
  return by_variant(4, variant, cluster, threads, (size_t)smem, dims, ptrs,
                    shard, (cudaStream_t)stream, nullptr);
}

// how many clusters of `cluster` CTAs of `threads` threads and `smem`
// bytes of dynamic shared memory each the card can run at once for the
// instantiation `variant` of K1, of K5 with bit 4 of `variant` set, or
// of the sharded K1 with bit 5 set (cudaOccupancyMaxActiveClusters): 0
// when it cannot schedule one. -> the CUDA error code.
extern "C" int scan_max_clusters(int variant, int cluster, int threads,
                                 long long smem, int* count) {
  *count = 0;
  if (cluster < 1 || smem < 0 || smem > SCAN_MAX_SHARED_BYTES
      || variant < 0 || variant > 63 || (variant & 48) == 48)
    return (int)cudaErrorInvalidValue;
  const int op = variant & 32 ? 5 : variant & 16 ? 3 : 2;
  return by_variant(op, variant & 15, cluster, threads, (size_t)smem,
                    nullptr, nullptr, nullptr, nullptr, count);
}

// K6: kind 0 launches the pass (K6a) over pods [k0, k0 + count), a block
// a pod; kind 1 the repair (K6b) of the same pods, one CTA. variant: bit
// 3 the int64 layout, bit 2 the spread tier (no affinity, no ANTI:
// spec_kernel.plan).
template <typename T, bool HAS_SPREAD>
static cudaError_t spec_dispatch(int kind, int k0, int count, int threads,
                                 size_t smem, const long long* dims,
                                 const unsigned long long* ptrs,
                                 cudaStream_t stream) {
  const Params<T> a = unpack<T>(dims, ptrs);
  if (k0 < 0 || count < 1 || (long long)k0 + count > a.P)
    return cudaErrorInvalidValue;
  const long long E = 5 + 4 * (long long)(sizeof(T) / 4) + a.L + a.PW
                      + 4LL * a.K + (HAS_SPREAD ? a.G : 0);
  // the dynamic shared memory each kernel is opened to, at any size: a
  // launch whose static and dynamic shared memory together pass 48 KB
  // needs it too (set_attributes opens only past 48 KB of dynamic)
  static long long set[2] = {-1, -1};   // K6a's, K6b's
  auto open_smem = [&](auto kernel, int which) {
    cudaError_t e = cudaSuccess;
    if ((long long)smem > set[which]) {
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e == cudaSuccess) set[which] = (long long)smem;
    }
    return e;
  };
  cudaError_t err;
  if (count > SPEC_TOP_MAX) return cudaErrorInvalidValue;
  if (kind == 0) {
    // spec_kernel.pass_bytes: the pod's row, its N composites, the
    // selected entries and the histogram; the slot digits are two bytes
    if (a.N > 65536
        || (long long)smem < ((4 * E + 7) & ~7LL)
                             + (long long)sizeof(T) * (a.N + SPEC_TOP_MAX)
                             + 4LL * (SPEC_TOP_MAX + 256))
      return cudaErrorInvalidValue;
    auto launch = [&](auto kernel) {
      cudaError_t e = open_smem(kernel, 0);
      if (e != cudaSuccess) return e;
      kernel<<<count, threads, smem, stream>>>(a, k0, count);
      return cudaGetLastError();
    };
    if constexpr (sizeof(T) == 8 && HAS_SPREAD)
      return launch(spec_pass_kernel_1<T, HAS_SPREAD>);
    else
      return launch(spec_pass_kernel<T, HAS_SPREAD>);
  }
  // spec_kernel.repair_bytes: two sets of count + 1 records, the pod
  // rows, two words a group, a slot a pod, a record a slot; a producer
  // thread (but the last producer warp's) a list entry and a record
  const long long gs = HAS_SPREAD ? a.G : 0;
  const long long set_bytes = (count + 1LL)
      * (4LL * (long long)sizeof(T) + 4 * (1 + a.PW + 2LL * a.K + gs));
  const long long rec = ((set_bytes + 7) & ~7LL) + set_bytes;
  const int warps = threads / 32;
  if (threads % 32 != 0 || threads > SPEC_REPAIR_THREADS
      || 32 * (warps - (warps + 3) / 4 - 1) < count
      || (long long)smem < rec + 4 * count * E + 8LL * a.G + 4LL * count
                               + 2LL * a.N)
    return cudaErrorInvalidValue;
  auto kernel = spec_repair_kernel<T, HAS_SPREAD>;
  err = open_smem(kernel, 1);
  if (err != cudaSuccess) return err;
  kernel<<<1, threads, smem, stream>>>(a, k0, count);
  return cudaGetLastError();
}

extern "C" int spec_launch(int kind, int variant, int k0, int count,
                           int threads, long long smem, const long long* dims,
                           const unsigned long long* ptrs, void* stream) {
  if (kind < 0 || kind > 1 || dims[DIM_P] <= 0 || dims[DIM_N] <= 0
      || smem < 0 || smem > SCAN_MAX_SHARED_BYTES)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t b = (size_t)smem;
  switch (variant) {
    case 0: return (int)spec_dispatch<int32_t, false>(kind, k0, count, threads, b, dims, ptrs, st);
    case 4: return (int)spec_dispatch<int32_t, true>(kind, k0, count, threads, b, dims, ptrs, st);
    case 8: return (int)spec_dispatch<int64_t, false>(kind, k0, count, threads, b, dims, ptrs, st);
    case 12: return (int)spec_dispatch<int64_t, true>(kind, k0, count, threads, b, dims, ptrs, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* scan_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
