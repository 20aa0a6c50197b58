// A group's trajectory (its J virtual commits on every node), on Hopper
// (sm_90a).
//
// Replaces no TPU kernel. The JAX package builds the trajectory as an XLA
// scan (open_simulator_tpu/ops/fast.py build_trajectory); the port ran the
// J steps as a Python loop of ~100 small PyTorch kernels a step over [N, R]
// and [N, G] rows, so a group's trajectory cost the host ~3,300 launches.
// This kernel runs every step of every node in one launch. Its plain
// version is that loop (ops/fast.py:build_trajectory; the wrapper is
// ops/trajectory.py); the two agree bit for bit.
//
// What it computes. A group of identical pods whose host-port and
// open-local state cannot change (the wrapper's caller routes only those
// here): lane j of node n is the node after j commits of the pod. For each
// lane, before that lane's commit, exactly as build_trajectory's step():
//   - free[n, j, :], the resources left;
//   - res_fail: resource_fail's static test (req > free + eps on any
//     resource), then the whole-GPU test against allocatable_gpus;
//   - with GPU dynamics (the template flag), gpu_free[n, j, :], the take
//     _gpu_take makes (tightest fit for one share, ties to the lowest
//     device; the clipped prefix fill for several), gpu_mask and
//     gpu_share_raw;
//   - packed[n, j, :] = (free cpu, free mem, res_fail, port_ok, sto_ok,
//     gpu_ok, sto_raw, gpu_raw), the channels the scans read; the port and
//     storage channels, and the GPU ones of a group without GPU dynamics,
//     are the entry rows the wrapper passes, the same in every lane.
// Then the commit: free -= req (one rounded subtraction a lane, never
// j * req) and gpu_free -= take * gpu_mem (the product rounded, then the
// difference).
//
// Design: one thread a node row. Nothing crosses nodes, so no thread waits
// for another; the only chain is the thread's own, along J. A lane's rows
// are the thread's output rows of the lane before, read back after it
// wrote them (R and G are the cluster's widths, known at the launch only),
// so the state costs no buffer of its own and the outputs are written once.
// Bytes: J * (R + 8 + 2G) floats a node written (~7.3 MB at 2,048 rows,
// J = 32, R = 4, G = 8), the entry rows read once.
//
// Exactness: every rounded expression is an explicit __fadd_rn / __fsub_rn
// / __fmul_rn / __fdiv_rn in the order of ops/kernels.py, and the file is
// built with --fmad=false (utils/platform.py:NVCC_FLAGS), so nothing is
// contracted. The sums over devices add whole numbers, left to right as a
// sequential fold does; clamp keeps NaN as torch.clamp does, min and max
// propagate it as torch.minimum and amax do, and the argmin takes the first
// minimum as torch.argmin does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChannels = 8;  // Trajectory.packed's channels (ops/fast.py)
constexpr float kEps = 1e-3f;  // ops/kernels.py _EPS

// channels of a packed row
constexpr int CH_CPU = 0, CH_MEM = 1, CH_RES_FAIL = 2, CH_PORT_OK = 3, CH_STO_OK = 4,
              CH_GPU_OK = 5, CH_STO_RAW = 6, CH_GPU_RAW = 7;

struct Params {
  const float* free0;      // [N, R] the carry's free resources
  const float* gpu_free0;  // [N, G] the carry's free GPU memory per device
  const float* gpu_total;  // [N, G]
  const float* alloc;      // [N, R]
  const float* req;        // [R]
  const float* gpu_mem;    // [] per-share GPU memory
  const float* gpu_num;    // [] shares
  const uint8_t* has_req;  // [] bool
  const float* port_ok;    // [N] entry rows, 0 or 1
  const float* sto_ok;     // [N]
  const float* sto_raw;    // [N]
  const float* gpu_ok;     // [N] without GPU dynamics only
  const float* gpu_raw;    // [N] without GPU dynamics only
  float* free_out;         // [N, J, R]
  float* gpu_free_out;     // [N, J, G] with GPU dynamics only
  float* gpu_take_out;     // [N, J, G] with GPU dynamics only
  float* packed_out;       // [N, J, 8]
  int n, j, r, g;
  int gpu_count_idx;       // the whole-GPU count's resource column
};

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

// allocatable_gpus: devices that exist and hold more than eps free.
__device__ __forceinline__ float allocatable(const float* gf, const float* total, int G) {
  float count = 0.0f;
  for (int d = 0; d < G; ++d)
    if (gf[d] > kEps && total[d] > 0.0f) count = __fadd_rn(count, 1.0f);
  return count;
}

// floor((free_d + eps) / mem) shares device d can still hold, 0 where there
// is no device: _gpu_device_caps, and _gpu_take's caps.
__device__ __forceinline__ float device_cap(float fd, float td, float mem_c) {
  return td > 0.0f ? floorf(__fdiv_rn(__fadd_rn(fd, kEps), mem_c)) : 0.0f;
}

// resource_fail at free row f, with `ag` allocatable GPUs.
__device__ __forceinline__ bool resource_fail(const Params& p, const float* f,
                                              const float* alloc, float ag) {
  bool fail = false;
  for (int k = 0; k < p.r; ++k) fail = fail || p.req[k] > __fadd_rn(f[k], kEps);
  const int c = p.gpu_count_idx;
  const float whole_used = __fsub_rn(alloc[c], f[c]);
  return fail || p.req[c] > __fadd_rn(__fsub_rn(ag, whole_used), kEps);
}

// gpu_share_raw of the node, with `ag` allocatable GPUs.
__device__ __forceinline__ float share_raw(const Params& p, const float* alloc, float ag,
                                           bool has_req) {
  float raw = 0.0f;
  for (int k = 0; k < p.r; ++k) {
    const float rq = p.req[k];
    const float avail = __fsub_rn(k == p.gpu_count_idx ? ag : alloc[k], rq);
    float share = rq == 0.0f ? 0.0f : (avail == 0.0f ? 1.0f : __fdiv_rn(rq, avail));
    if (avail < 0.0f) share = 1.0f;
    raw = k == 0 ? share : nan_max(raw, share);
  }
  return has_req ? __fmul_rn(raw, 100.0f) : 100.0f;
}

template <bool kDynGpu>
__global__ void __launch_bounds__(kThreads) trajectory_kernel(const Params p) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= p.n) return;
  const int R = p.r, G = p.g, J = p.j;
  const float* alloc = p.alloc + (size_t)n * R;
  const float* total = p.gpu_total + (size_t)n * G;
  const float* free0 = p.free0 + (size_t)n * R;
  float* free_row = p.free_out + (size_t)n * J * R;
  float* packed = p.packed_out + (size_t)n * J * kChannels;
  const bool has_req = p.has_req[0] != 0;
  const float port_ok = p.port_ok[n], sto_ok = p.sto_ok[n], sto_raw = p.sto_raw[n];

  // the GPU state of a group that cannot change it: its entry rows
  float ag = 0.0f, gpu_ok = 0.0f, gpu_raw = 0.0f;
  float mem = 0.0f, num = 0.0f, mem_c = 0.0f, mem_eps = 0.0f;
  float* gf_row = nullptr;
  float* take_row = nullptr;
  if (kDynGpu) {
    mem = p.gpu_mem[0];
    num = p.gpu_num[0];
    mem_c = mem < 1e-9f ? 1e-9f : mem;  // clamp(min=1e-9), NaN kept
    mem_eps = __fsub_rn(mem, kEps);
    gf_row = p.gpu_free_out + (size_t)n * J * G;
    take_row = p.gpu_take_out + (size_t)n * J * G;
  } else {
    ag = allocatable(p.gpu_free0 + (size_t)n * G, total, G);
    gpu_ok = p.gpu_ok[n];
    gpu_raw = p.gpu_raw[n];
  }

  for (int j = 0; j < J; ++j) {
    // lane j: the entry rows, or lane j - 1 after its commit
    float* f = free_row + (size_t)j * R;
    if (j == 0) {
      for (int k = 0; k < R; ++k) f[k] = free0[k];
    } else {
      for (int k = 0; k < R; ++k) f[k] = __fsub_rn(f[k - R], p.req[k]);
    }
    if (kDynGpu) {
      float* gf = gf_row + (size_t)j * G;
      if (j == 0) {
        const float* src = p.gpu_free0 + (size_t)n * G;
        for (int d = 0; d < G; ++d) gf[d] = src[d];
      } else {
        const float* prev_take = take_row + (size_t)(j - 1) * G;
        for (int d = 0; d < G; ++d) gf[d] = __fsub_rn(gf[d - G], __fmul_rn(prev_take[d], mem));
      }
      ag = allocatable(gf, total, G);

      // _gpu_take: the eligible devices' tightest fit (first minimum), the
      // caps and their sum; gpu_mask reads the same sum
      float* take = take_row + (size_t)j * G;
      float tight_v = 0.0f, cap_sum = 0.0f;
      int tight = 0;
      bool any_elig = false;
      for (int d = 0; d < G; ++d) {
        const bool elig = total[d] > 0.0f && gf[d] >= mem_eps;
        const float v = elig ? gf[d] : __int_as_float(0x7f800000);
        if (d == 0 || v < tight_v) { tight_v = v; tight = d; }
        any_elig = any_elig || elig;
        cap_sum = __fadd_rn(cap_sum, device_cap(gf[d], total[d], mem_c));
      }
      const bool on = mem > 0.0f && num >= 1.0f;
      const bool multi_fits = cap_sum >= num;
      float run = 0.0f;
      for (int d = 0; d < G; ++d) {
        const float cap = device_cap(gf[d], total[d], mem_c);
        const float cum = __fadd_rn(run, cap);
        const float prefix = __fsub_rn(cum, cap);
        run = cum;
        float t = __fsub_rn(num, prefix);
        t = t < 0.0f ? 0.0f : t;  // clamp(min=0), NaN kept
        const float multi = multi_fits ? nan_min(t, cap) : 0.0f;
        const float single = (d == tight && any_elig) ? 1.0f : 0.0f;
        take[d] = on ? (num == 1.0f ? single : multi) : 0.0f;
      }
      gpu_ok = (mem > 0.0f ? (num >= 1.0f && cap_sum >= num) : true) ? 1.0f : 0.0f;
      gpu_raw = share_raw(p, alloc, ag, has_req);
    }

    const bool fail = resource_fail(p, f, alloc, ag);
    float4* out = reinterpret_cast<float4*>(packed + (size_t)j * kChannels);
    out[0] = make_float4(f[CH_CPU], f[CH_MEM], fail ? 1.0f : 0.0f, port_ok);
    out[1] = make_float4(sto_ok, gpu_ok, sto_raw, gpu_raw);
  }
}

static_assert(CH_RES_FAIL == 2 && CH_PORT_OK == 3 && CH_STO_OK == 4 && CH_GPU_OK == 5 &&
              CH_STO_RAW == 6 && CH_GPU_RAW == 7, "packed's channel order");

}  // namespace

extern "C" int trajectory_launch(
    const void* free0, const void* gpu_free0, const void* gpu_total, const void* alloc,
    const void* req, const void* gpu_mem, const void* gpu_num, const void* has_req,
    const void* port_ok, const void* sto_ok, const void* sto_raw, const void* gpu_ok,
    const void* gpu_raw, void* free_out, void* gpu_free_out, void* gpu_take_out,
    void* packed_out, int n, int j, int r, int g, int dyn_gpu, int gpu_count_idx,
    void* stream) {
  if (n < 1 || j < 1 || r < 2 || g < 0 || gpu_count_idx < 0 || gpu_count_idx >= r)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.free0 = static_cast<const float*>(free0);
  p.gpu_free0 = static_cast<const float*>(gpu_free0);
  p.gpu_total = static_cast<const float*>(gpu_total);
  p.alloc = static_cast<const float*>(alloc);
  p.req = static_cast<const float*>(req);
  p.gpu_mem = static_cast<const float*>(gpu_mem);
  p.gpu_num = static_cast<const float*>(gpu_num);
  p.has_req = static_cast<const uint8_t*>(has_req);
  p.port_ok = static_cast<const float*>(port_ok);
  p.sto_ok = static_cast<const float*>(sto_ok);
  p.sto_raw = static_cast<const float*>(sto_raw);
  p.gpu_ok = static_cast<const float*>(gpu_ok);
  p.gpu_raw = static_cast<const float*>(gpu_raw);
  p.free_out = static_cast<float*>(free_out);
  p.gpu_free_out = static_cast<float*>(gpu_free_out);
  p.gpu_take_out = static_cast<float*>(gpu_take_out);
  p.packed_out = static_cast<float*>(packed_out);
  p.n = n; p.j = j; p.r = r; p.g = g;
  p.gpu_count_idx = gpu_count_idx;
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dyn_gpu) trajectory_kernel<true><<<blocks, kThreads, 0, s>>>(p);
  else trajectory_kernel<false><<<blocks, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
