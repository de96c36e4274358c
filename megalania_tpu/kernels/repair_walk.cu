// CUDA build of the repair+cost walk (repair_walk.h) for Hopper (sm_90a):
// one warp per chain, the chain's int16 probability row and the log2 table
// in shared memory.  Registered as the XLA FFI target's CUDA implementation
// (ops/repair_walk.py).
#include <cuda_runtime.h>

#include <climits>

#include "repair_walk_ffi.h"

namespace meg {

constexpr unsigned FULL = 0xffffffffu;

struct DeviceWarp {
  int lane;
  __device__ DeviceWarp() : lane(static_cast<int>(threadIdx.x & 31)) {}
  template <class F>
  __device__ int reduce_add(int count, F f) const {
    int v = 0;
    for (int k = lane; k < count; k += 32) v += f(k);
    return __reduce_add_sync(FULL, v);
  }
  template <class F>
  __device__ unsigned reduce_or(int count, F f) const {
    unsigned v = 0;
    for (int k = lane; k < count; k += 32) v |= f(k);
    return __reduce_or_sync(FULL, v);
  }
  template <class F>
  __device__ int reduce_max(int count, F f) const {
    int v = INT_MIN;
    for (int k = lane; k < count; k += 32) v = imax(v, f(k));
    return __reduce_max_sync(FULL, v);
  }
  template <class F>
  __device__ int reduce_min(int count, F f) const {
    int v = INT_MAX;
    for (int k = lane; k < count; k += 32) v = imin(v, f(k));
    return __reduce_min_sync(FULL, v);
  }
  template <class F>
  __device__ void each(int begin, int end, F f) const {
    for (int k = begin + lane; k < end; k += 32) f(k);
  }
  __device__ void sync() const { __syncwarp(); }
  __device__ bool leader() const { return lane == 0; }
};

__global__ void __launch_bounds__(32) repair_walk_kernel(WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* log2 = reinterpret_cast<int32_t*>(smem);
  int16_t* probs = reinterpret_cast<int16_t*>(log2 + PROB_ONE);
  const int c = static_cast<int>(blockIdx.x);
  const DeviceWarp w;
  w.each(0, PROB_ONE, [&](int k) { log2[k] = a.log2[k]; });
  w.each(0, a.P, [&](int k) {
    probs[k] = static_cast<int16_t>(a.probs_in[static_cast<size_t>(c) * a.P + k]);
  });
  w.sync();
  walk_chain(w, a, c, probs, log2);
}

ffi::Error RepairWalkCuda(cudaStream_t stream, MEG_WALK_PARAMS) {
  WalkArgs a;
  ffi::Error err = make_walk_args(a, MEG_WALK_FORWARD);
  if (err.failure()) return err;
  const size_t smem = PROB_ONE * sizeof(int32_t) + a.P * sizeof(int16_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        repair_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  }
  repair_walk_kernel<<<a.C, 32, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

}  // namespace meg

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    MegRepairWalkCuda, meg::RepairWalkCuda,
    xla::ffi::Ffi::Bind()
        .Ctx<xla::ffi::PlatformStream<cudaStream_t>>() MEG_WALK_OPERANDS);

// Occupancy of the launch shape for a probability row of P slots, for the
// smoke test's report: resident warps (chains) per SM.
extern "C" int meg_walk_blocks_per_sm(int P) {
  int blocks = 0;
  const size_t smem = meg::PROB_ONE * sizeof(int32_t) + P * sizeof(int16_t);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, meg::repair_walk_kernel, 32, smem) != cudaSuccess)
    return -1;
  return blocks;
}
