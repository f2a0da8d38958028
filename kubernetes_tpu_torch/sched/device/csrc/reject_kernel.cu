// The row-wise argsort kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of kubernetes_tpu/kubemark/tpu_evidence.py
// (_section_pallas._bad_call.bad_kernel): o[r, :] = argsort(x[r, :]) as
// int32, on f32[8, 128]. Mosaic has no lowering for that body, which was
// the point of the TPU kernel: it proved a real kernel rejection reaches
// the caller. This kernel computes the same function and is launched
// twice by the evidence tool: once correctly, and once with a block too
// large to launch, to show that a refused launch raises.
//
// Order: jnp.argsort's, which is a stable sort under XLA's sort keys:
// +0 and -0 are one key (so are denormals, which XLA flushes to zero on
// the CPU and the TPU), every NaN sorts after +inf, and equal keys keep
// their index order.
//
// Bound: bytes, and at this size launch latency. The function moves
// 8 KiB (4 KiB in, 4 KiB out): 2.4 ns at 3.35 TB/s. A simple design is
// enough: one block per row; the row's keys go into shared memory; each
// thread ranks its elements by counting the elements that sort before
// them (C compares each, ties broken by index) and scatters its index to
// that rank. O(C^2) compares per row, which at C = 128 is 16k per block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC; argsort_rows_launch is the plain-C entry point that
// kubernetes_tpu_torch/sched/device/reject_kernel.py calls through ctypes.

#include <cstdint>
#include <cuda_runtime.h>

// XLA's float sort key: zeros and denormals become +0 (flag 0);
// NaN becomes key 0 with flag 1, so NaNs order among themselves by index
__device__ __forceinline__ void sort_key(float v, float* key, int* nan) {
  if (v != v) {
    *key = 0.0f;
    *nan = 1;
  } else {
    *key = fabsf(v) < 1.17549435e-38f ? 0.0f : v;
    *nan = 0;
  }
}

__global__ void argsort_rows_kernel(int C, const float* __restrict__ x,
                                    int32_t* __restrict__ out) {
  extern __shared__ float keys[];              // [C] keys, then [C] flags
  int* nans = reinterpret_cast<int*>(keys + C);
  const size_t row = blockIdx.x;
  const float* xr = x + row * C;
  int32_t* outr = out + row * C;
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    sort_key(xr[i], &keys[i], &nans[i]);
  __syncthreads();
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    const float ki = keys[i];
    const int ni = nans[i];
    int rank = 0;
    for (int j = 0; j < C; ++j) {
      const float kj = keys[j];
      const int nj = nans[j];
      const bool before =
          (nj < ni) ||
          (nj == ni && (kj < ki || (kj == ki && j < i)));
      rank += before ? 1 : 0;
    }
    outr[rank] = i;
  }
}

// threads is the block size; the wrapper picks min(C, 1024) rounded to a
// warp. A caller may pass more than the card's 1024 on purpose: the
// launch is then refused (cudaErrorInvalidConfiguration, which does not
// poison the context) and its code is returned.
extern "C" int argsort_rows_launch(int R, int C, int threads, const void* x,
                                   void* out, void* stream) {
  const size_t shmem = (size_t)C * (sizeof(float) + sizeof(int));
  argsort_rows_kernel<<<R, threads, shmem, (cudaStream_t)stream>>>(
      C, (const float*)x, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* argsort_rows_error_name(int err) {
  return cudaGetErrorName((cudaError_t)err);
}
