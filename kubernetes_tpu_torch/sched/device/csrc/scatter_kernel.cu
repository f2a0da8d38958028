// The dirty-row scatter kernel (K3) for Hopper (sm_90a): a delta tile's
// whole table prologue in one launch.
//
// Replaces the XLA program of the JAX engine's device table mirror
// (kubernetes_tpu/sched/device/engine.py, _scatter_rows_fn, called by
// _scatter_table): write the rows that the encoder's TableDelta journal
// marks dirty into every per-slot column of the device mirror, in place.
// The columns are bool (1 byte), int32 and int64 vectors and the 2-D
// word columns labels [N, L], port_bits [N, PW], disk_any / disk_rw
// [N, K]; each is row-major with a fixed number of bytes a row.
//
// One launch does what a delta tile needs before the scan: both tables'
// dirty rows into the mirror, and the run's own State from the mirror's
// (the scan commits into its State in place, so a run never scans on the
// mirror). The host packs one staging buffer a tile, copied to the
// device once:
//   [descriptors][node indices][State indices][State skip bitmap]
//   [the packed rows of each field] ... [the pod columns]
// each section 16-byte aligned (scatter_kernel.Prologue). A descriptor is
// one of two kinds:
//   SCATTER  packed rows -> rows idx[r] of a column, and of a second
//            column where one is named (a dirty State row goes into the
//            mirror and into the run's State);
//   COPY     one column into another, skipping the rows a bitmap marks
//            (the State's dirty rows: those the SCATTER writes into the
//            run's State from the staging buffer, so that no thread reads
//            a mirror row that another thread of the same launch writes).
// A descriptor names its index section or bitmap by address, so one
// launch serves any number of field groups. The pod columns are not the
// kernel's: the engine reads them as views into the same device buffer.
//
// blockIdx.y picks the descriptor; the x blocks stride over its elements
// (words of `word` bytes: 8, 4, 2 or 1, the widest that divides the row
// and the columns' alignment). Element t is word t % W of row t / W: the
// division is one 32-bit multiply-high and a shift by the descriptor's
// precomputed magic number (exact for t < 2^31), not an int64 division.
// Neighbouring threads read neighbouring words of the staging buffer or
// of the source column, and write contiguous words of one row.
//
// Bound: bytes (bounds.prologue_bound). The function reads the indices,
// the packed rows and the mirror's State once and writes the dirty rows
// and the run's State once; it does no arithmetic beyond addresses. At
// the e2e's tiles that is tens of KB, far below what one launch costs
// (~1.2 us), so the design spends nothing but the copy: no shared
// memory, no atomics, one pass, and one launch where the tile used to
// take two scatters and 13 clones.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; scatter_launch is the plain-C entry point that
// kubernetes_tpu_torch/sched/device/scatter_kernel.py calls through
// ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#define SCATTER_BLOCK_THREADS 256

enum ScatterKind { KIND_SCATTER = 0, KIND_COPY = 1 };

// one descriptor; must match scatter_kernel.py's DESCRIPTOR (64 bytes)
struct ScatterDesc {
  uint64_t dst;        // device pointer written
  uint64_t dst2;       // SCATTER: a second column written, or 0
  uint64_t src;        // the packed rows (SCATTER) or the source column
  uint64_t aux;        // SCATTER: int64 row indices; COPY: skip bitmap or 0
  int32_t elems;       // words to move: rows x words a row
  int32_t words;       // words a row
  int32_t word;        // bytes a word: 8, 4, 2 or 1
  int32_t kind;        // ScatterKind
  uint32_t magic;      // t / words == umulhi(t, magic) >> shift (words > 1)
  int32_t shift;
  int64_t pad;
};

// the row of element t: t / words without a division
__device__ __forceinline__ int row_of(const ScatterDesc& d, int t) {
  return d.words == 1 ? t : (int)(__umulhi((unsigned)t, d.magic) >> d.shift);
}

template <typename T>
__device__ __forceinline__ void move_words(const ScatterDesc& d) {
  const T* __restrict__ src = (const T*)d.src;
  T* __restrict__ dst = (T*)d.dst;
  const int stride = gridDim.x * blockDim.x;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (d.kind == KIND_SCATTER) {
    const int64_t* __restrict__ idx = (const int64_t*)d.aux;
    T* __restrict__ dst2 = (T*)d.dst2;
    for (; t < d.elems; t += stride) {
      const int r = row_of(d, t);
      const size_t at = (size_t)idx[r] * d.words + (t - r * d.words);
      const T v = src[t];
      dst[at] = v;
      if (dst2 != nullptr) dst2[at] = v;
    }
  } else {
    const uint32_t* __restrict__ skip = (const uint32_t*)d.aux;
    for (; t < d.elems; t += stride) {
      if (skip != nullptr) {
        const int r = row_of(d, t);
        if ((skip[r >> 5] >> (r & 31)) & 1u) continue;
      }
      dst[t] = src[t];
    }
  }
}

__global__ void __launch_bounds__(SCATTER_BLOCK_THREADS)
scatter_kernel(const ScatterDesc* __restrict__ descs) {
  const ScatterDesc d = descs[blockIdx.y];
  if ((int)(blockIdx.x * blockDim.x) >= d.elems) return;
  switch (d.word) {
    case 8: move_words<uint64_t>(d); break;
    case 4: move_words<uint32_t>(d); break;
    case 2: move_words<uint16_t>(d); break;
    default: move_words<uint8_t>(d); break;
  }
}

// Queue the prologue on `stream`: grid_x blocks a descriptor, n_desc
// descriptors at `descs` (the device staging buffer's first section).
// Returns the CUDA error of the launch (0 = launched).
extern "C" int scatter_launch(int grid_x, int n_desc, const void* descs,
                              void* stream) {
  if (grid_x <= 0 || n_desc <= 0 || n_desc > 65535 || descs == nullptr)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, n_desc);
  scatter_kernel<<<grid, SCATTER_BLOCK_THREADS, 0, (cudaStream_t)stream>>>(
      (const ScatterDesc*)descs);
  return (int)cudaGetLastError();
}

extern "C" const char* scatter_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
