// Helpers shared by the kernel wrappers: readable CUDA error names, and
// the host's time to encode one TMA tensor map (the wgmma forms encode
// three to five a launch).

#include <cuda_runtime.h>

#include <chrono>

#include "hopper.cuh"

extern "C" const char* loco_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Host microseconds a cuTensorMapEncodeTiled of a [8, 12, 500, 64] bf16 map
// at ``base`` (16-byte aligned; nothing is read), the mean of ``reps``
// encodes as the wgmma launches make them; -1 when the driver has no
// encoder or refuses the map.
extern "C" double loco_tensor_map_encode_us(const void* base, int reps) {
  uint64_t dims[4], strides[3];
  bhtd_map(dims, strides, 64, 500, 12, 8, 64 * 12, 64, 500LL * 64 * 12);
  CUtensorMap map;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (encode_bf16_map(&map, base, dims, strides, 64) != cudaSuccess) return -1.0;
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return reps > 0 ? dt.count() / reps : 0.0;
}
