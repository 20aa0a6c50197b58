// The first version of the domain_pop kernel (one pop = a rebuild of every
// count, three shuffle reductions, a dependent head load and a barrier-fenced
// count update), kept unchanged except for clock64() stamps around its stages
// (and a __syncwarp() before the two stamps that follow lane-local work).
// A measurement tool: tools/pop_stages.py builds it and prints the SM cycles
// each stage of a pop takes. The package never builds or calls it.
//
// Stamps are read by thread 0 only. A stamp does not wait for loads in
// flight, so the winner's dependent head load shows up in the first stage
// that reads its value (the total), not in "head advance".

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr float kEps = 1e-3f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStages = 7;  // counts, raw max, divide, total max, argmin, head advance, count update

struct Params {
  const float* hscore;       // [Dc,L]
  const int* hnode;          // [Dc,L]
  const int* hj;             // [Dc,L]
  const int* cap_eff;        // [Dc]
  const float* elig;         // [Dc]
  const float* combo_valid;  // [Dc]
  const float* base_dom;     // [C,D]
  const float* in_key;       // [C,D]
  const float* t_onehot;     // [C,D,Dc]
  const float* match;        // [C]
  const float* soft;         // [C]
  const float* hard;         // [C]
  const float* skew;         // [C]
  const float* has_key;      // [C,Dc]
  int* nodes_out;            // [G]
  int* jidx_out;             // [G]
  unsigned long long* stamps;  // [kStages + 2]: cycles per stage, loop cycles, loop ns
  int dc, l, c, d, g, valid_count, any_hard, fo_spread, big_n;
  float w_sp;
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ unsigned long long clk() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
  return t;
}

__device__ __forceinline__ unsigned long long ns_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red, int nwarps) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  if (nwarps == 1) return v;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  return fmaxf(red[0], red[1]);
}

__device__ __forceinline__ void block_argmin(int& key, int& idx, int* redk,
                                             int* redi, int nwarps) {
  for (int o = 16; o > 0; o >>= 1) {
    const int k2 = __shfl_xor_sync(kFull, key, o);
    const int i2 = __shfl_xor_sync(kFull, idx, o);
    if (k2 < key || (k2 == key && i2 < idx)) { key = k2; idx = i2; }
  }
  if (nwarps == 1) return;
  if ((threadIdx.x & 31) == 0) { redk[threadIdx.x >> 5] = key; redi[threadIdx.x >> 5] = idx; }
  __syncthreads();
  const bool second = redk[1] < redk[0] || (redk[1] == redk[0] && redi[1] < redi[0]);
  key = second ? redk[1] : redk[0];
  idx = second ? redi[1] : redi[0];
}

__global__ void __launch_bounds__(64) domain_pop_stages_kernel(Params p) {
  extern __shared__ float smem[];
  const int C = p.c, D = p.d, Dc = p.dc, L = p.l;
  const int CD = C * D;
  float* s_dom = smem;
  float* s_inkey = s_dom + CD;
  float* s_t = s_inkey + CD;
  float* s_haskey = s_t + CD * Dc;
  float* s_match = s_haskey + C * Dc;
  float* s_soft = s_match + C;
  float* s_hard = s_soft + C;
  float* s_skew = s_hard + C;
  float* s_elig = s_skew + C;
  float* s_red = s_elig + Dc;
  float* s_redt = s_red + 2;
  int* s_redk = reinterpret_cast<int*>(s_redt + 2);
  int* s_redi = s_redk + 2;

  const int tid = threadIdx.x, nthr = blockDim.x, nwarps = nthr >> 5;
  for (int q = tid; q < CD; q += nthr) { s_dom[q] = p.base_dom[q]; s_inkey[q] = p.in_key[q]; }
  for (int q = tid; q < CD * Dc; q += nthr) s_t[q] = p.t_onehot[q];
  for (int q = tid; q < C * Dc; q += nthr) s_haskey[q] = p.has_key[q];
  for (int q = tid; q < C; q += nthr) {
    s_match[q] = p.match[q]; s_soft[q] = p.soft[q];
    s_hard[q] = p.hard[q]; s_skew[q] = p.skew[q];
  }
  for (int q = tid; q < Dc; q += nthr) s_elig[q] = p.elig[q];

  const int m = tid;
  const bool real = m < Dc;
  const bool cvalid = real && p.combo_valid[m] > 0.f;
  const int cap = real ? p.cap_eff[m] : 0;
  int h = 0;
  float hs = -inf_f();
  int nd = 0, jv = 0;
  if (real) {
    hs = cap > 0 ? p.hscore[m * L] : -inf_f();
    nd = p.hnode[m * L];
    jv = p.hj[m * L];
  }
  __syncthreads();

  unsigned long long acc[kStages] = {0, 0, 0, 0, 0, 0, 0};
  const unsigned long long loop_ns0 = ns_now();
  const unsigned long long loop0 = clk();
  unsigned long long t = loop0, t2;
  for (int i = 0; i < p.g; ++i) {
    float raw = 0.f;
    bool spread_ok = true;
    if (real) {
      for (int c = 0; c < C; ++c) {
        const float* dom_c = s_dom + c * D;
        float cnt = 0.f;
        for (int dd = 0; dd < D; ++dd)
          cnt = __fadd_rn(cnt, __fmul_rn(dom_c[dd], s_t[(c * D + dd) * Dc + m]));
        if (s_soft[c] > 0.f) raw = __fadd_rn(raw, cnt);
        if (p.any_hard && s_hard[c] > 0.f) {
          float mn = inf_f();
          for (int dd = 0; dd < D; ++dd)
            if (s_inkey[c * D + dd] > 0.f) mn = fminf(mn, dom_c[dd]);
          const float min_c = mn < inf_f() ? mn : 0.f;
          const bool ok_c =
              __fsub_rn(__fadd_rn(cnt, 1.0f), min_c) <= __fadd_rn(s_skew[c], kEps) &&
              s_haskey[c * Dc + m] > 0.f;
          spread_ok = spread_ok && ok_c;
        }
      }
    }
    __syncwarp();
    t2 = clk(); acc[0] += t2 - t; t = t2;
    const float mx = block_max(cvalid ? raw : 0.f, s_red, nwarps);
    t2 = clk(); acc[1] += t2 - t; t = t2;
    float sp = 100.f;
    if (mx > 0.f) sp = __fdiv_rn(__fmul_rn(__fsub_rn(mx, raw), 100.f), fmaxf(mx, 1e-9f));
    sp = fminf(fmaxf(sp, 0.f), 100.f);
    __syncwarp();
    t2 = clk(); acc[2] += t2 - t; t = t2;

    float total = -inf_f();
    if (real) {
      total = __fadd_rn(hs, __fmul_rn(p.w_sp, sp));
      if (p.any_hard && !(spread_ok || !p.fo_spread)) total = -inf_f();
    }
    const float mx_t = block_max(total, s_redt, nwarps);
    t2 = clk(); acc[3] += t2 - t; t = t2;
    int key = real ? (total == mx_t ? nd : p.big_n) : INT_MAX;
    int win = m;
    block_argmin(key, win, s_redk, s_redi, nwarps);
    const bool ok = mx_t > -inf_f() && i < p.valid_count;
    t2 = clk(); acc[4] += t2 - t; t = t2;

    if (m == win) {
      p.nodes_out[i] = ok ? nd : -1;
      p.jidx_out[i] = ok ? jv : 0;
      if (ok) {
        ++h;
        const int nhc = h < L - 1 ? h : L - 1;
        hs = h < cap ? p.hscore[m * L + nhc] : -inf_f();
        nd = p.hnode[m * L + nhc];
        jv = p.hj[m * L + nhc];
      }
    }
    __syncthreads();
    t2 = clk(); acc[5] += t2 - t; t = t2;
    if (ok) {
      const float e = s_elig[win];
      for (int q = tid; q < CD; q += nthr)
        s_dom[q] = __fadd_rn(s_dom[q], __fmul_rn(__fmul_rn(s_match[q / D], s_t[q * Dc + win]), e));
    }
    __syncthreads();
    t2 = clk(); acc[6] += t2 - t; t = t2;
  }
  const unsigned long long loop1 = clk();
  const unsigned long long loop_ns1 = ns_now();
  if (tid == 0) {
    for (int k = 0; k < kStages; ++k) p.stamps[k] = acc[k];
    p.stamps[kStages] = loop1 - loop0;
    p.stamps[kStages + 1] = loop_ns1 - loop_ns0;
  }
}

}  // namespace

extern "C" int domain_pop_stages_launch(
    const void* hscore, const void* hnode, const void* hj, const void* cap_eff,
    const void* elig, const void* combo_valid, const void* base_dom,
    const void* in_key, const void* t_onehot, const void* match,
    const void* soft, const void* hard, const void* skew, const void* has_key,
    void* nodes_out, void* jidx_out, void* stamps, int dc, int l, int c, int d, int g,
    int valid_count, int any_hard, int fo_spread, int big_n, float w_sp,
    int smem_bytes, void* stream) {
  Params p;
  p.hscore = static_cast<const float*>(hscore);
  p.hnode = static_cast<const int*>(hnode);
  p.hj = static_cast<const int*>(hj);
  p.cap_eff = static_cast<const int*>(cap_eff);
  p.elig = static_cast<const float*>(elig);
  p.combo_valid = static_cast<const float*>(combo_valid);
  p.base_dom = static_cast<const float*>(base_dom);
  p.in_key = static_cast<const float*>(in_key);
  p.t_onehot = static_cast<const float*>(t_onehot);
  p.match = static_cast<const float*>(match);
  p.soft = static_cast<const float*>(soft);
  p.hard = static_cast<const float*>(hard);
  p.skew = static_cast<const float*>(skew);
  p.has_key = static_cast<const float*>(has_key);
  p.nodes_out = static_cast<int*>(nodes_out);
  p.jidx_out = static_cast<int*>(jidx_out);
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.dc = dc; p.l = l; p.c = c; p.d = d; p.g = g;
  p.valid_count = valid_count; p.any_hard = any_hard; p.fo_spread = fo_spread;
  p.big_n = big_n; p.w_sp = w_sp;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        domain_pop_stages_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = dc <= 32 ? 32 : 64;
  domain_pop_stages_kernel<<<1, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
