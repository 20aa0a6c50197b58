// The dependent chain of one light_scan step, alone: the floor under
// csrc/light_scan.cu.
//
// A measurement kernel, not a kernel of the main path. One block of the
// scan kernel's kThreads threads runs `steps` times only what every step of
// that kernel needs and what each step needs of the one before: the step's
// two block reductions (the min/max of a raw channel and the first-max
// argmax, each a warp butterfly, one barrier and a second butterfly over
// the warps' partials, double-buffered by step parity) with one subtraction
// and one comparison a node between them, each thread's values in registers
// (no memory traffic). The winner's value falls each step, so every step
// waits for the one before. The reductions are the scan kernel's own, copied
// here as csrc/pop_chain_probe.cu copies domain_pop's chain.
// tools/scan_cases.py:chain_probe_ms builds, launches and times it;
// chip_smoke.py prints the floor beside the kernel's time; PERF.md gives
// the bound. Built with ops/domain_pop.py:NVCC_FLAGS like the kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;  // csrc/light_scan.cu's block
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

__device__ __forceinline__ bool ranks_above(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (ranks_above(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

__device__ __forceinline__ void warp_minmax(float4& m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m.x = nan_min(m.x, __shfl_xor_sync(0xffffffffu, m.x, off));
    m.y = nan_max(m.y, __shfl_xor_sync(0xffffffffu, m.y, off));
    m.z = nan_min(m.z, __shfl_xor_sync(0xffffffffu, m.z, off));
    m.w = nan_max(m.w, __shfl_xor_sync(0xffffffffu, m.w, off));
  }
}

__device__ float4 block_minmax(float4 m, float4* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_minmax(m);
  if (lane == 0) part[warp] = m;
  __syncthreads();
  const float inf = __int_as_float(0x7f800000);
  m = lane < kWarps ? part[lane] : make_float4(inf, -inf, inf, -inf);
  warp_minmax(m);
  return m;
}

__device__ void block_argmax(float& v, int& i, float* part_v, int* part_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) { part_v[warp] = v; part_i[warp] = i; }
  __syncthreads();
  const float neg_inf = -__int_as_float(0x7f800000);
  if (lane < kWarps) { v = part_v[lane]; i = part_i[lane]; }
  else { v = neg_inf; i = 0x7fffffff; }
  warp_argmax(v, i);
}

// The probe: `steps` chained steps over n nodes.
constexpr int kProbePer = 8;  // nodes a thread: n <= kThreads * kProbePer

__global__ void __launch_bounds__(kThreads, 1) chain_probe_kernel(int n, int steps, int* out) {
  __shared__ float4 mm_part[2][kWarps];
  __shared__ float am_v[2][kWarps];
  __shared__ int am_i[2][kWarps];
  const int tid = threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  float v[kProbePer];
#pragma unroll
  for (int k = 0; k < kProbePer; ++k) v[k] = static_cast<float>((tid + k * kThreads) % 97);
  int best_i = 0;
  for (int i = 0; i < steps; ++i) {
    const int par = i & 1;
    float4 mm = make_float4(inf, -inf, inf, -inf);
#pragma unroll
    for (int k = 0; k < kProbePer; ++k)
      if (tid + k * kThreads < n) { mm.x = nan_min(mm.x, v[k]); mm.y = nan_max(mm.y, v[k]); }
    const float4 lim = block_minmax(mm, mm_part[par]);
    float best = -inf;
    best_i = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < kProbePer; ++k) {
      const int node = tid + k * kThreads;
      const float s = __fsub_rn(v[k], lim.x);
      if (node < n && ranks_above(s, node, best, best_i)) { best = s; best_i = node; }
    }
    block_argmax(best, best_i, am_v[par], am_i[par]);
#pragma unroll
    for (int k = 0; k < kProbePer; ++k)
      if (tid + k * kThreads == best_i) v[k] = __fsub_rn(v[k], 1.0f);
  }
  if (tid == 0) out[0] = best_i;
}

}  // namespace

extern "C" int scan_chain_probe_launch(int n, int steps, void* out, void* stream) {
  if (n < 1 || n > kThreads * kProbePer || steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  chain_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(n, steps,
                                                                            static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
