// Latency of the single operations a domain_pop pop chains together, each
// timed with clock64() as a chain of n dependent repetitions in one warp.
// A measurement tool: tools/chain_ops.py builds it and prints SM cycles per
// repetition. The package never builds or calls it.
//
// mode 0: __reduce_max_sync on u32      mode 1: 5-step __shfl_xor_sync max
// mode 2: 2-step __shfl_xor_sync max    mode 3: __fdiv_rn
// mode 4: shared-memory load            mode 5: f32 -> u32 -> f32 conversion
// mode 6: __fadd_rn                     mode 7: one pop of 4 classes kept by
//         one thread in registers (no cross-lane step at all)

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(__fadd_rn(x, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void __launch_bounds__(32) chain_ops_kernel(int mode, int n, float* io,
                                                        unsigned long long* out) {
  __shared__ int s_next[32 * 32];
  __shared__ float s_tab[4 * 4];
  const int lane = threadIdx.x;
  for (int q = lane; q < 32 * 32; q += 32) s_next[q] = (q * 17 + 5) & 1023;
  if (lane < 16) s_tab[lane] = static_cast<float>((lane * 5) & 1);
  __syncwarp();
  float f = io[lane];
  unsigned u = static_cast<unsigned>(lane);
  int idx = lane;
  float r0 = f, r1 = f + 1.f, r2 = f + 2.f, r3 = f + 3.f;
  float h0 = 1.f, h1 = 2.f, h2 = 1.5f, h3 = 0.5f;
  int nd0 = 7, nd1 = 3, nd2 = 11, nd3 = 5;
  const long long t0 = clock64();
  switch (mode) {
    case 0:
      for (int i = 0; i < n; ++i) u = __reduce_max_sync(kFull, u ^ static_cast<unsigned>(lane)) + 1u;
      break;
    case 1:
      for (int i = 0; i < n; ++i) {
        for (int o = 16; o > 0; o >>= 1) u = max(u, __shfl_xor_sync(kFull, u, o));
        u ^= static_cast<unsigned>(lane);
      }
      break;
    case 2:
      for (int i = 0; i < n; ++i) {
        for (int o = 2; o > 0; o >>= 1) u = max(u, __shfl_xor_sync(kFull, u, o));
        u ^= static_cast<unsigned>(lane);
      }
      break;
    case 3:
      for (int i = 0; i < n; ++i) f = __fdiv_rn(f, 1.0000001f);
      break;
    case 4:
      for (int i = 0; i < n; ++i) idx = s_next[idx];
      break;
    case 5:
      for (int i = 0; i < n; ++i) f = __uint2float_rn(__float2uint_rz(f) + 1u);
      break;
    case 6:
      for (int i = 0; i < n; ++i) f = __fadd_rn(f, 1.0f);
      break;
    case 7:
      for (int i = 0; i < n; ++i) {
        const float mx = fmaxf(fmaxf(r0, r1), fmaxf(r2, r3));
        const float t0_ = __fadd_rn(h0, __fmul_rn(2.f, __fdiv_rn(__fmul_rn(__fsub_rn(mx, r0), 100.f), mx)));
        const float t1_ = __fadd_rn(h1, __fmul_rn(2.f, __fdiv_rn(__fmul_rn(__fsub_rn(mx, r1), 100.f), mx)));
        const float t2_ = __fadd_rn(h2, __fmul_rn(2.f, __fdiv_rn(__fmul_rn(__fsub_rn(mx, r2), 100.f), mx)));
        const float t3_ = __fadd_rn(h3, __fmul_rn(2.f, __fdiv_rn(__fmul_rn(__fsub_rn(mx, r3), 100.f), mx)));
        const unsigned o0 = ordered(t0_), o1 = ordered(t1_), o2 = ordered(t2_), o3 = ordered(t3_);
        const unsigned mt = max(max(o0, o1), max(o2, o3));
        const unsigned k0 = (static_cast<unsigned>(o0 == mt ? nd0 : 4096) << 6) | 0u;
        const unsigned k1 = (static_cast<unsigned>(o1 == mt ? nd1 : 4096) << 6) | 1u;
        const unsigned k2 = (static_cast<unsigned>(o2 == mt ? nd2 : 4096) << 6) | 2u;
        const unsigned k3 = (static_cast<unsigned>(o3 == mt ? nd3 : 4096) << 6) | 3u;
        const int w = static_cast<int>(min(min(k0, k1), min(k2, k3)) & 63u);
        r0 = __fadd_rn(r0, s_tab[w * 4 + 0]);
        r1 = __fadd_rn(r1, s_tab[w * 4 + 1]);
        r2 = __fadd_rn(r2, s_tab[w * 4 + 2]);
        r3 = __fadd_rn(r3, s_tab[w * 4 + 3]);
        nd0 += w == 0; nd1 += w == 1; nd2 += w == 2; nd3 += w == 3;
      }
      f = r0 + r1 + r2 + r3 + static_cast<float>(nd0 + nd1 + nd2 + nd3);
      break;
  }
  const long long t1 = clock64();
  io[lane] = f + static_cast<float>(u) + static_cast<float>(idx);
  if (lane == 0) out[0] = static_cast<unsigned long long>(t1 - t0);
}

}  // namespace

extern "C" int chain_ops_launch(int mode, int n, void* io, void* out, void* stream) {
  chain_ops_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      mode, n, static_cast<float*>(io), static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
