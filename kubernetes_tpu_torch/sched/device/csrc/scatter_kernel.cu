// The dirty-row scatter kernel for Hopper (sm_90a).
//
// Replaces the XLA program of the JAX engine's device table mirror
// (kubernetes_tpu/sched/device/engine.py, _scatter_rows_fn, called by
// _scatter_table): write the R rows that the encoder's TableDelta journal
// marks dirty into every per-slot column of one device table, in place.
// The columns are bool (1 byte), int32 and int64 vectors and the 2-D
// word columns labels [N, L], port_bits [N, PW], disk_any / disk_rw
// [N, K]; each is row-major with a fixed number of bytes a row.
//
// One launch serves every column of a table: the host packs, into one
// staging buffer copied to the device before the launch,
//   [n_fields descriptors][R slot indices, int64][the R rows of field 0]
//   [the R rows of field 1] ...
// with each section 16-byte aligned. A descriptor names the column's
// device pointer, its bytes a row, the offset of its packed rows in the
// staging buffer, and the word the copy moves (8, 4, 2 or 1 bytes: the
// widest that divides the row and the column's alignment). blockIdx.y
// picks the field; the x blocks stride over its R x (row / word) words.
// Element t of a field is word t % W of packed row t / W, written to
// word t % W of row idx[t / W] of the column: so neighbouring threads
// read neighbouring words of the staging buffer, and the writes of one
// row are contiguous.
//
// Bound: bytes. The function reads the indices and the packed rows once
// and writes the rows once; it does no arithmetic beyond addresses. At
// the e2e's handful of dirty rows a table it moves a few KB, far below
// what one launch costs; at R = 5000 (every row of a 5000-node table)
// ~0.6 MB, ~0.2 us at 3.35 TB/s. So the design spends nothing but the
// copy: no shared memory, no synchronisation, one pass.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; scatter_rows_launch is the plain-C entry point that
// kubernetes_tpu_torch/sched/device/scatter_kernel.py calls through
// ctypes.

#include <cstdint>
#include <cuda_runtime.h>

#define SCATTER_BLOCK_THREADS 256

// one column of the table; must match scatter_kernel.py's DESCRIPTOR
struct ScatterField {
  uint64_t dst;        // device pointer of the column
  int64_t row_bytes;   // bytes a row
  int64_t src_off;     // byte offset of the packed rows in the staging
  int64_t word;        // bytes a copied word: 8, 4, 2 or 1
};

template <typename T>
__device__ __forceinline__ void copy_words(const ScatterField& f,
                                           const int64_t* __restrict__ idx,
                                           const uint8_t* __restrict__ staging,
                                           int64_t total, int64_t w) {
  const T* __restrict__ src = (const T*)(staging + f.src_off);
  T* __restrict__ dst = (T*)f.dst;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = t / w;
    dst[idx[r] * w + (t - r * w)] = src[t];
  }
}

__global__ void __launch_bounds__(SCATTER_BLOCK_THREADS)
scatter_rows_kernel(const uint8_t* __restrict__ staging, int R,
                    int64_t idx_off) {
  const ScatterField f = ((const ScatterField*)staging)[blockIdx.y];
  const int64_t* __restrict__ idx = (const int64_t*)(staging + idx_off);
  const int64_t w = f.row_bytes / f.word;         // words a row
  const int64_t total = (int64_t)R * w;
  switch (f.word) {
    case 8: copy_words<uint64_t>(f, idx, staging, total, w); break;
    case 4: copy_words<uint32_t>(f, idx, staging, total, w); break;
    case 2: copy_words<uint16_t>(f, idx, staging, total, w); break;
    default: copy_words<uint8_t>(f, idx, staging, total, w); break;
  }
}

// Queue the scatter on `stream`: grid_x blocks a field, n_fields fields,
// R rows, the slot indices at byte idx_off of the device staging buffer.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int scatter_rows_launch(int grid_x, int n_fields, int R,
                                   long long idx_off, const void* staging,
                                   void* stream) {
  if (grid_x <= 0 || n_fields <= 0 || R <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(grid_x, n_fields);
  scatter_rows_kernel<<<grid, SCATTER_BLOCK_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint8_t*)staging, R, (int64_t)idx_off);
  return (int)cudaGetLastError();
}

extern "C" const char* scatter_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
