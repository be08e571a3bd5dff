// Packed link-history scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gpud_tpu/ops/pallas_scan.py:_scan_kernel.
// For each link row l of a packed [L, T] history (each link's samples
// left-aligned, `valid` a prefix mask) it computes, with t over [0, T-2]:
//
//   up(x)   := x >= 1          down(x) := x <= 0        (int8 state)
//   pair(t) := valid[t] && valid[t+1]
//   drops          = sum pair(t) * up(s[t]) * down(s[t+1])
//   flaps          = sum pair(t) * down(s[t]) * up(s[t+1])
//   samples        = sum valid[t]                        (t over all of T)
//   currently_down = samples > 0 && !(valid[n-1] && up(s[n-1])), n = samples
//   counter_delta  = sum pair(t) * max(c[t+1] - c[t], 0)  (int64)
//
// and writes them as one row of an [L, 5] int64 output, in that order.
// The TPU kernel's f32 sums are exact only below 2^24; this one sums the
// counter steps in int64 and is exact for any int32 counters.
//
// What bounds it on the H100: device memory. It reads 6 bytes per sample
// (int8 state, int32 counter, bool valid) and does about two integer
// operations per byte, well below the ten or more the card's cores can
// execute for each byte its memory delivers. The Pallas kernel read
// 12 bytes per sample (three padded f32 arrays); this design reads each
// input byte once, at its stored width: no f32 upcast, no padding, no
// staging copy.
//
// Design (simple and right first): one warp per link row, 8 warps per
// 256-thread block, a grid of ceil(L / 8) blocks. Lane i strides over t =
// i, i+32, ..., so neighbouring lanes read neighbouring bytes; the t+1
// reads hit the same 32-byte sectors in L1. Counts accumulate in int32
// registers and the counter delta in int64, reduced across the warp with
// __shfl_xor_sync. Lane 0 then reads the last valid sample and writes the
// row. T == 1 (no pairs), all-invalid rows and L == 0 (no launch, handled
// by the Python wrapper) need no special case here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreadsPerBlock = kWarpsPerBlock * 32;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ bool is_up(int8_t x) { return x >= 1; }
__device__ __forceinline__ bool is_down(int8_t x) { return x <= 0; }

__global__ void __launch_bounds__(kThreadsPerBlock)
packed_scan_kernel(const int8_t* __restrict__ states,
                   const int32_t* __restrict__ counters,
                   const uint8_t* __restrict__ valid,
                   int64_t L, int64_t T,
                   int64_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= L) return;  // whole warps leave together: row is warp-uniform

  const int8_t* s = states + row * T;
  const int32_t* c = counters + row * T;
  const uint8_t* v = valid + row * T;

  int drops = 0, flaps = 0, samples = 0;
  long long delta = 0;
  for (int64_t t = lane; t < T; t += 32) {
    const bool v0 = v[t] != 0;
    samples += v0;
    if (v0 && t + 1 < T && v[t + 1] != 0) {
      const int8_t a = s[t], b = s[t + 1];
      drops += is_up(a) & is_down(b);
      flaps += is_down(a) & is_up(b);
      const long long step =
          static_cast<long long>(c[t + 1]) - static_cast<long long>(c[t]);
      delta += step > 0 ? step : 0;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    drops += __shfl_xor_sync(kFullMask, drops, off);
    flaps += __shfl_xor_sync(kFullMask, flaps, off);
    samples += __shfl_xor_sync(kFullMask, samples, off);
    delta += __shfl_xor_sync(kFullMask, delta, off);
  }
  if (lane == 0) {
    bool down = false;
    if (samples > 0) {
      const int64_t last = samples - 1;
      down = !(v[last] != 0 && is_up(s[last]));
    }
    int64_t* o = out + row * 5;
    o[0] = drops;
    o[1] = flaps;
    o[2] = down ? 1 : 0;
    o[3] = samples;
    o[4] = delta;
  }
}

}  // namespace

// Launches the scan on `stream`. All pointers are device pointers to
// contiguous row-major [L, T] inputs and an [L, 5] output; 0 < L and
// 0 < T < 2^31 are checked by the caller. Returns cudaGetLastError().
extern "C" int gpud_packed_scan(const void* states, const void* counters,
                                const void* valid, int64_t L, int64_t T,
                                void* out, void* stream) {
  const int64_t blocks = (L + kWarpsPerBlock - 1) / kWarpsPerBlock;
  packed_scan_kernel<<<static_cast<unsigned>(blocks), kThreadsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(states), static_cast<const int32_t*>(counters),
      static_cast<const uint8_t*>(valid), L, T, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
