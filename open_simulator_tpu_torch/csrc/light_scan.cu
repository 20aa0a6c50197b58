// Light-scan steps of one chunk of a node-local group, on Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package runs these steps as an XLA scan
// (open_simulator_tpu/ops/fast.py:656 light_scan); the port ran them as a
// Python loop that launched ~94 small PyTorch kernels a step, so the card
// sat idle ~95 % of the scan's time while the host issued them (PERF.md).
// This kernel runs every step of a chunk in one launch. Its plain version is
// that loop, the general body of ops/fast.py:light_scan (the wrapper is
// ops/light_scan.py); the two agree bit for bit.
//
// What it computes. A group of identical pods whose every score and mask is
// a function of the node's own trajectory row: no spread or inter-pod
// affinity term, only resources, host ports, open-local storage and GPU
// share evolve. Node n sits at commit count x[n] and row cur[n] =
// packed[n, x[n]] of the group's trajectory. Each step:
//   1. the min and max over valid nodes of each dynamic raw channel (GPU
//      share, and open-local when storage evolves), for Simon's
//      NormalizeScore;
//   2. every node's mask and score exactly as _light_eval computes them,
//      the weighted left fold over WEIGHT_ORDER in its order (the wrapper
//      passes one term code per fold position), -inf where infeasible, and
//      the first maximum (lowest index on ties, NaN above all, as
//      torch.argmax);
//   3. the output (node, x[node]), or (-1, 0) when the maximum is -inf;
//   4. on success x[node] += 1 and cur[node] = packed[node, min(x_old + 1,
//      J - 1)], the lane's raw bits as index_select copies them.
// A failed step commits nothing, so every later step fails the same way:
// the block writes (-1, 0) to the rest of the chunk and ends.
//
// What bounds it: the per-step dependent chain. Step i + 1 needs step i's
// winner, so a chunk of G steps costs G chains of two block reductions (the
// min/max and the argmax, each a warp butterfly, one barrier and a second
// butterfly over the warps' partials) plus the per-node arithmetic between
// them (the ten-term fold, ~25 f32 operations, and an IEEE divide for each
// normalised term that moves; N / kThreads nodes a thread). Bytes are ~35 a
// node a step, in L1 after the first step. tools/scan_cases.py's
// chain_probe_ms times the chain alone (csrc/scan_chain_probe.cu).
//
// Design: one block of kThreads threads, no shared state but the reduction
// partials. Thread t owns nodes t, t + kThreads, ...: only it reads and
// writes their working rows (la, ba, the GPU and storage raw values or the
// frozen GPU score, the feasibility byte, x), so a winner's refresh needs no
// barrier. The node-local score parts that move only when the node wins
// (LeastAllocated, BalancedAllocation, feasibility) are computed at its
// refresh, not every step; the fold itself runs every step for every node
// because the normalised GPU and storage terms sit between them in the fold
// and f32 addition is not associative. The partials are double-buffered by
// step parity, so a step needs two barriers (one without dynamic raw
// channels).
//
// Exactness: every rounded expression is an explicit __fadd_rn / __fsub_rn /
// __fmul_rn / __fdiv_rn in the order of ops/kernels.py's _la_ba,
// _minmax_normalize and combine_scores, and the file is built with
// --fmad=false (ops/domain_pop.py:NVCC_FLAGS), so nothing is contracted.
// clamp keeps NaN as torch.clamp does; min and max propagate NaN as
// torch.amin / amax do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChannels = 8;  // Trajectory.packed's channels (ops/fast.py)
constexpr int kTerms = 10;    // len(WEIGHT_ORDER)
constexpr int kMaxStatic = 8;

// channels of a packed row
constexpr int CH_CPU = 0, CH_MEM = 1, CH_RES_FAIL = 2, CH_PORT_OK = 3, CH_STO_OK = 4,
              CH_GPU_OK = 5, CH_STO_RAW = 6, CH_GPU_RAW = 7;

// term codes of the fold (ops/light_scan.py TERM_*): static row k is
// kStatic0 + k
constexpr int kBalanced = 0, kLeast = 1, kGpu = 2, kLocal = 3, kZero = 4, kHundred = 5,
              kStatic0 = 6;

struct Params {
  const float* packed;       // [N, J, 8]
  const int* x0;             // [N]
  const uint8_t* static_ok;  // [N] bool
  const uint8_t* valid;      // [N] bool
  const float* statics;      // [S, N]
  const float* alloc;        // [N, R]
  const float* req;          // [R]
  const float* weights;      // [kTerms]
  const uint8_t* fo;         // [NUM_FILTERS] bool
  const uint8_t* has_local;  // [] bool
  int* x_out;                // [N]
  int* nodes_out;            // [G]
  int* jidx_out;             // [G]
  float* work;               // [4, N]: la, ba, GPU raw (or frozen score), storage raw
  uint8_t* feas;             // [N]
  int n, j, r, steps, g;
  int dyn_ports, dyn_storage, dyn_gpu;
  int f_ports, f_resources;  // filter indices of fo
  int codes[kTerms];
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  // torch.clamp: NaN stays NaN
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (b < a ? b : a));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : (b > a ? b : a));
}

// Simon's NormalizeScore of one value, given the min and max over valid nodes.
__device__ __forceinline__ float normalize(float v, float lo, float hi) {
  const float rng = __fsub_rn(hi, lo);
  const float den = rng < 1e-9f ? 1e-9f : rng;
  const float out = rng > 0.0f ? __fdiv_rn(__fmul_rn(__fsub_rn(v, lo), 100.0f), den) : 0.0f;
  return clampf(out, 0.0f, 100.0f);
}

// (a, ia) ranks above (b, ib) in torch.argmax's order: NaN first, then the
// larger value, then the lower index.
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

// The block's min and max of the GPU (x, y) and storage (z, w) raw values
// over valid nodes; every thread gets the result. `part` is this step's
// partials buffer.
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

// LeastAllocated and BalancedAllocation of node n at free cpu/mem (c, m):
// ops/kernels.py:_la_ba.
__device__ __forceinline__ void la_ba(const Params& p, int n, float c, float m, float& la,
                                      float& ba) {
  const float a0 = p.alloc[(size_t)n * p.r], a1 = p.alloc[(size_t)n * p.r + 1];
  const float r0 = p.req[0], r1 = p.req[1];
  const float d0 = a0 < 1e-9f ? 1e-9f : a0, d1 = a1 < 1e-9f ? 1e-9f : a1;
  const float f0 = a0 > 0.0f ? __fdiv_rn(__fsub_rn(c, r0), d0) : 0.0f;
  const float f1 = a1 > 0.0f ? __fdiv_rn(__fsub_rn(m, r1), d1) : 0.0f;
  la = __fmul_rn(clampf(__fmul_rn(__fadd_rn(f0, f1), 0.5f), 0.0f, 1.0f), 100.0f);
  const float u0 = __fadd_rn(__fsub_rn(a0, c), r0), u1 = __fadd_rn(__fsub_rn(a1, m), r1);
  const float b0 = clampf(a0 > 0.0f ? __fdiv_rn(u0, d0) : 0.0f, 0.0f, 1.0f);
  const float b1 = clampf(a1 > 0.0f ? __fdiv_rn(u1, d1) : 0.0f, 0.0f, 1.0f);
  ba = __fmul_rn(__fsub_rn(1.0f, fabsf(__fsub_rn(b0, b1))), 100.0f);
}

// Node n's working row from its trajectory row `row`: la, ba, feasibility,
// and the raw values the fold normalises (the GPU raw only when it evolves;
// a frozen group keeps its entry score).
__device__ __forceinline__ void set_row(const Params& p, int n, const float* row, bool fo_res,
                                        bool fo_ports) {
  const size_t N = (size_t)p.n;
  float la, ba;
  la_ba(p, n, row[CH_CPU], row[CH_MEM], la, ba);
  p.work[n] = la;
  p.work[N + n] = ba;
  bool ok = p.static_ok[n] && p.valid[n] && !(row[CH_RES_FAIL] > 0.5f && fo_res);
  if (p.dyn_ports) ok = ok && (row[CH_PORT_OK] > 0.5f || !fo_ports);
  if (p.dyn_storage) {
    ok = ok && row[CH_STO_OK] > 0.5f;
    p.work[3 * N + n] = row[CH_STO_RAW];
  }
  if (p.dyn_gpu) {
    ok = ok && row[CH_GPU_OK] > 0.5f;
    p.work[2 * N + n] = row[CH_GPU_RAW];
  }
  p.feas[n] = ok;
}

__global__ void __launch_bounds__(kThreads, 1) light_scan_kernel(const Params p) {
  __shared__ float4 mm_part[2][kWarps];
  __shared__ float am_v[2][kWarps];
  __shared__ int am_i[2][kWarps];
  const int tid = threadIdx.x;
  const int N = p.n;
  const size_t NN = (size_t)N;
  const float inf = __int_as_float(0x7f800000), neg_inf = -inf;
  const bool fo_res = p.fo[p.f_resources] != 0, fo_ports = p.fo[p.f_ports] != 0;
  const bool local_on = p.dyn_storage && p.has_local[0] != 0;
  float w[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) w[k] = p.weights[k];

  // prologue: x and cur = packed[n, x] + 0.0 (0 out of range), as cur_at
  // reads them; the frozen GPU score of a group whose GPU state is fixed
  float4 mm = make_float4(inf, -inf, inf, -inf);
  for (int n = tid; n < N; n += kThreads) {
    const int x = p.x0[n];
    p.x_out[n] = x;
    float row[kChannels];
    const bool inb = x >= 0 && x < p.j;
    const float* src = p.packed + ((size_t)n * p.j + (inb ? x : 0)) * kChannels;
#pragma unroll
    for (int c = 0; c < kChannels; ++c) row[c] = inb ? __fadd_rn(src[c], 0.0f) : 0.0f;
    set_row(p, n, row, fo_res, fo_ports);
    if (!p.dyn_gpu) {
      const float g = row[CH_GPU_RAW];
      p.work[2 * NN + n] = g;
      if (p.valid[n]) { mm.x = nan_min(mm.x, g); mm.y = nan_max(mm.y, g); }
    }
  }
  if (!p.dyn_gpu) {
    mm = block_minmax(mm, mm_part[1]);
    for (int n = tid; n < N; n += kThreads)
      p.work[2 * NN + n] = normalize(p.work[2 * NN + n], mm.x, mm.y);
  }

  const bool need_minmax = p.dyn_gpu || p.dyn_storage;
  int i = 0;
  for (; i < p.steps; ++i) {
    const int par = i & 1;
    float4 lim = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (need_minmax) {
      mm = make_float4(inf, -inf, inf, -inf);
      for (int n = tid; n < N; n += kThreads) {
        if (!p.valid[n]) continue;
        if (p.dyn_gpu) {
          const float g = p.work[2 * NN + n];
          mm.x = nan_min(mm.x, g); mm.y = nan_max(mm.y, g);
        }
        if (p.dyn_storage) {
          const float s = p.work[3 * NN + n];
          mm.z = nan_min(mm.z, s); mm.w = nan_max(mm.w, s);
        }
      }
      lim = block_minmax(mm, mm_part[par]);
    }

    float best = neg_inf;
    int best_i = 0x7fffffff;
    for (int n = tid; n < N; n += kThreads) {
      float total = 0.0f;
#pragma unroll
      for (int k = 0; k < kTerms; ++k) {
        const int code = p.codes[k];
        float v;
        if (code == kBalanced) v = p.work[NN + n];
        else if (code == kLeast) v = p.work[n];
        else if (code == kGpu) v = p.dyn_gpu ? normalize(p.work[2 * NN + n], lim.x, lim.y)
                                             : p.work[2 * NN + n];
        else if (code == kLocal) v = local_on ? normalize(p.work[3 * NN + n], lim.z, lim.w) : 0.0f;
        else if (code == kZero) v = 0.0f;
        else if (code == kHundred) v = 100.0f;
        else v = p.statics[(size_t)(code - kStatic0) * NN + n];
        const float term = __fmul_rn(w[k], v);
        total = k == 0 ? term : __fadd_rn(total, term);
      }
      const float score = p.feas[n] ? total : neg_inf;
      if (ranks_above(score, n, best, best_i)) { best = score; best_i = n; }
    }
    block_argmax(best, best_i, am_v[par], am_i[par]);
    if (!(best > neg_inf)) break;  // nothing feasible: no later step places

    const int win = best_i;
    if (win % kThreads == tid) {
      const int x = p.x_out[win];
      p.nodes_out[i] = win;
      p.jidx_out[i] = x;
      p.x_out[win] = x + 1;
      const int jn = min(max(x + 1, 0), p.j - 1);
      const float* src = p.packed + ((size_t)win * p.j + jn) * kChannels;
      float row[kChannels];
#pragma unroll
      for (int c = 0; c < kChannels; ++c) row[c] = src[c];
      set_row(p, win, row, fo_res, fo_ports);
    }
  }
  for (int k = i + tid; k < p.g; k += kThreads) {
    p.nodes_out[k] = -1;
    p.jidx_out[k] = 0;
  }
}

}  // namespace

extern "C" int light_scan_launch(
    const void* packed, const void* x0, const void* static_ok, const void* valid,
    const void* statics, const void* alloc, const void* req, const void* weights,
    const void* fo, const void* has_local, void* x_out, void* nodes_out, void* jidx_out,
    void* work, void* feas, int n, int j, int r, int steps, int g, int dyn_ports,
    int dyn_storage, int dyn_gpu, int f_ports, int f_resources, const int* codes, void* stream) {
  Params p;
  p.packed = static_cast<const float*>(packed);
  p.x0 = static_cast<const int*>(x0);
  p.static_ok = static_cast<const uint8_t*>(static_ok);
  p.valid = static_cast<const uint8_t*>(valid);
  p.statics = static_cast<const float*>(statics);
  p.alloc = static_cast<const float*>(alloc);
  p.req = static_cast<const float*>(req);
  p.weights = static_cast<const float*>(weights);
  p.fo = static_cast<const uint8_t*>(fo);
  p.has_local = static_cast<const uint8_t*>(has_local);
  p.x_out = static_cast<int*>(x_out);
  p.nodes_out = static_cast<int*>(nodes_out);
  p.jidx_out = static_cast<int*>(jidx_out);
  p.work = static_cast<float*>(work);
  p.feas = static_cast<uint8_t*>(feas);
  p.n = n; p.j = j; p.r = r; p.steps = steps; p.g = g;
  p.dyn_ports = dyn_ports; p.dyn_storage = dyn_storage; p.dyn_gpu = dyn_gpu;
  p.f_ports = f_ports; p.f_resources = f_resources;
  for (int k = 0; k < kTerms; ++k) {
    if (codes[k] < 0 || codes[k] >= kStatic0 + kMaxStatic)
      return static_cast<int>(cudaErrorInvalidValue);
    p.codes[k] = codes[k];
  }
  light_scan_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
