// The two one-line kernels of scripts/repro_pallas_interpret_vma.py
// (`kernel_literal`: o = x * 2.0, `kernel_no_literal`: o = x + x), fp32,
// elementwise (sm_90a).
//
// The original pair exists to show a jax fault: in Pallas interpret mode,
// inside a partial-manual shard_map, both fail the varying-axes check (the
// first on its literal, the second on the interpreter's own loop carry).
// CUDA has no such mode and no such fault; what is kept here are the two
// kernels, whose results must be bit-equal (x * 2 and x + x are the same
// fp32 value for every x, NaN payloads aside).
//
// What bounds them: bytes. At the script's [8, 128] fp32 shape that is 8 KiB
// (4 KiB in, 4 KiB out), 2.4 ns at 3.35 TB/s: the launch itself (a few
// microseconds) is the floor, and one block of 256 threads per 256 elements
// is all the design there is.
#include <cuda_runtime.h>

namespace videoitg {

__global__ void double_literal_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] * 2.0f;
}

__global__ void double_no_literal_kernel(const float* __restrict__ x, float* __restrict__ o,
                                         int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + x[i];
}

}  // namespace videoitg

// x, out: contiguous fp32, n elements. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int videoitg_double_literal_f32(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  videoitg::double_literal_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int videoitg_double_no_literal_f32(const void* x, void* out, int n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  videoitg::double_no_literal_kernel<<<(n + 255) / 256, 256, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
