// Packed link-history scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel gpud_tpu/ops/pallas_scan.py:_scan_kernel
// (pallas_call at :119). For each link row l of a packed [L, T] history
// (each link's samples left-aligned, `valid` a prefix mask) it computes,
// with t over [0, T-2]:
//
//   up(x)   := x >= 1          down(x) := x <= 0        (signed int8 state)
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
// What bounds it on the H100: HBM bytes. It reads 6 bytes per sample (int8
// state, int32 counter, bool valid), each once, and writes 40 bytes per
// row; its dozen integer operations per sample are far below what the
// cores can do for each byte the memory delivers.
//
// Bytes in flight (Little's law): to stream at 3.35 TB/s with about 0.7 us
// of load latency the card needs about 2.3 MB in flight, 18 KB per SM.
// Loads of one sample per lane (32 to 128 bytes per warp request) keep a
// small fraction of that in flight. So each lane takes 16 consecutive
// samples per step with one 16-byte load of states, one of valid and four
// of counters (96 bytes), all issued before any is used: a step is one
// memory round trip and a warp covers 512 samples (3 steps at T = 1440,
// 40 at T = 20160). One warp per row and 4 warps per
// block: the 4608 rows of a pod are 1152 blocks, all resident at once
// (9 blocks, 36 warps per SM, at most 56 registers a thread), so one step
// of all resident warps puts 36 * 32 * 96 B = 110 KB in flight per SM.
//
// No sample is read twice: a lane scores the pairs that end in its chunk,
// (t0-1, t0) .. (t0+14, t0+15). The sample t0-1 comes from lane-1 by
// shuffle; lane 0 takes it from the carry, the previous step's last sample,
// broadcast from that step's last lane. Predicates are bit masks (bit j for
// sample j of a chunk): pairs, drops, flaps and samples are a few logic
// operations and popcounts per chunk. States are signed: up is computed by
// byte SIMD on 32-bit words as "nonzero with the sign bit clear", so -1 is
// down. The row's result is a warp reduction: no atomics, no second pass.
//
// Alignment rule: the vector step needs 16-byte aligned addresses in all
// three arrays. With 16-byte aligned base pointers, a flat element index
// (row * T + t) that is a multiple of 16 aligns all three (16 counters are
// 64 bytes). Each row scans a scalar head (one sample per lane per step)
// up to the first such index, the vector body, and a scalar tail; when
// T % 16 == 0 every row is vector body throughout. When a base pointer is
// not 16-byte aligned (a view with a storage offset), every row takes the
// scalar step, in this same kernel. T == 1, all-invalid rows and any mask
// need no other case; L == 0 launches nothing (the Python wrapper).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreadsPerBlock = kWarpsPerBlock * 32;
// 4608 rows / 4 warps = 1152 blocks over 132 SMs: 9 blocks per SM
constexpr int kMinBlocksPerSM = 9;
constexpr int kVec = 16;  // samples per lane per vector step
constexpr unsigned kFullMask = 0xffffffffu;

// Bit 7 of each byte of the result is set iff that byte of w is nonzero.
__device__ __forceinline__ uint32_t nonzero_msb(uint32_t w) {
  return (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
}

// Moves bits 7, 15, 23 and 31 (and no others may be set) to bits 0..3.
__device__ __forceinline__ uint32_t gather_msb(uint32_t m) {
  return (m * 0x00204081u) >> 28;
}

// Bit i: byte i of w, a signed int8 state, is up (>= 1).
__device__ __forceinline__ uint32_t up_bits(uint32_t w) {
  return gather_msb(nonzero_msb(w) & ~w);
}

// Bit i: byte i of w, a bool, is true.
__device__ __forceinline__ uint32_t valid_bits(uint32_t w) {
  return gather_msb(nonzero_msb(w));
}

// W consecutive samples of one row, held by one lane: bit j of `up` and
// `valid` for sample j, and the counters. All zero past the row's end.
template <int W>
struct Chunk {
  uint32_t up = 0, valid = 0;
  int32_t c[W] = {};
};

__device__ __forceinline__ void load(Chunk<1>& x, const int8_t* s,
                                     const int32_t* c, const uint8_t* v) {
  const int8_t s0 = __ldg(s);
  const uint8_t v0 = __ldg(v);
  x.c[0] = __ldg(c);
  x.up = s0 >= 1;
  x.valid = v0 != 0;
}

// s, c and v must be 16-byte aligned.
__device__ __forceinline__ void load(Chunk<kVec>& x, const int8_t* s,
                                     const int32_t* c, const uint8_t* v) {
  const uint4 sw = __ldg(reinterpret_cast<const uint4*>(s));
  const uint4 vw = __ldg(reinterpret_cast<const uint4*>(v));
  const int4* c4 = reinterpret_cast<const int4*>(c);
  const int4 q[4] = {__ldg(c4), __ldg(c4 + 1), __ldg(c4 + 2), __ldg(c4 + 3)};
  x.up = up_bits(sw.x) | up_bits(sw.y) << 4 | up_bits(sw.z) << 8 |
         up_bits(sw.w) << 12;
  x.valid = valid_bits(vw.x) | valid_bits(vw.y) << 4 |
            valid_bits(vw.z) << 8 | valid_bits(vw.w) << 12;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x.c[4 * i] = q[i].x;
    x.c[4 * i + 1] = q[i].y;
    x.c[4 * i + 2] = q[i].z;
    x.c[4 * i + 3] = q[i].w;
  }
}

// The last sample scanned so far: bit 0 up, bit 1 valid; and its counter.
struct Carry {
  uint32_t flags = 0;  // before a row's first sample: not valid
  int32_t counter = 0;
};

struct Acc {
  int drops = 0, flaps = 0, samples = 0;
  unsigned long long delta = 0;
};

// Scores the pairs that end in each lane's chunk. Lanes past the range's
// end hold an all-zero chunk; `last_lane` is the last lane inside it.
template <int W>
__device__ __forceinline__ void step(const Chunk<W>& x, int lane,
                                     int last_lane, Carry& carry, Acc& a) {
  const uint32_t flags =
      ((x.up >> (W - 1)) & 1u) | ((x.valid >> (W - 1)) & 1u) << 1;
  uint32_t prev_flags = __shfl_up_sync(kFullMask, flags, 1);
  int32_t prev_counter = __shfl_up_sync(kFullMask, x.c[W - 1], 1);
  if (lane == 0) {
    prev_flags = carry.flags;
    prev_counter = carry.counter;
  }
  carry.flags = __shfl_sync(kFullMask, flags, last_lane);
  carry.counter = __shfl_sync(kFullMask, x.c[W - 1], last_lane);

  // bit e is the chunk's sample e-1; bit 0 the sample before the chunk
  const uint32_t up = x.up << 1 | (prev_flags & 1u);
  const uint32_t valid = x.valid << 1 | prev_flags >> 1;
  const uint32_t pair = valid & valid << 1;  // bit e: pair (e-1, e)
  a.drops += __popc(pair & up << 1 & ~up);
  a.flaps += __popc(pair & ~(up << 1) & up);
  a.samples += __popc(x.valid);

  int32_t left = prev_counter;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const int32_t right = x.c[j];
    // a positive int32 step is below 2^32: exact in uint32
    if (((pair >> (j + 1)) & 1u) && right > left)
      a.delta += static_cast<uint32_t>(right) - static_cast<uint32_t>(left);
    left = right;
  }
}

// Scans the row's samples [lo, hi), W per lane per step. For W = kVec,
// hi - lo is a multiple of kVec and s + lo, c + lo, v + lo are aligned.
template <int W>
__device__ __forceinline__ void scan_range(const int8_t* s, const int32_t* c,
                                           const uint8_t* v, int64_t lo,
                                           int64_t hi, int lane, Carry& carry,
                                           Acc& a) {
  for (int64_t t = lo; t < hi; t += 32 * W) {
    const int64_t t0 = t + static_cast<int64_t>(lane) * W;
    Chunk<W> x;
    if (t0 < hi) load(x, s + t0, c + t0, v + t0);
    const int64_t last = (hi - 1 - t) / W;
    step(x, lane, last < 31 ? static_cast<int>(last) : 31, carry, a);
  }
}

__global__ void __launch_bounds__(kThreadsPerBlock, kMinBlocksPerSM)
packed_scan_kernel(const int8_t* __restrict__ states,
                   const int32_t* __restrict__ counters,
                   const uint8_t* __restrict__ valid, int64_t L, int64_t T,
                   int aligned, int64_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= L) return;  // whole warps leave together: row is warp-uniform

  const int64_t first = row * T;
  const int8_t* s = states + first;
  const int32_t* c = counters + first;
  const uint8_t* v = valid + first;

  // vector body [head, body_end): from the row's first flat index that is
  // a multiple of kVec, whole chunks only
  int64_t head = T, body_end = T;
  if (aligned) {
    const int64_t to_aligned = (-first) & (kVec - 1);
    head = to_aligned < T ? to_aligned : T;
    body_end = head + (T - head) / kVec * kVec;
  }
  Carry carry;
  Acc a;
  scan_range<1>(s, c, v, 0, head, lane, carry, a);
  scan_range<kVec>(s, c, v, head, body_end, lane, carry, a);
  scan_range<1>(s, c, v, body_end, T, lane, carry, a);

  const int drops = __reduce_add_sync(kFullMask, a.drops);
  const int flaps = __reduce_add_sync(kFullMask, a.flaps);
  const int samples = __reduce_add_sync(kFullMask, a.samples);
  unsigned long long delta = a.delta;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    delta += __shfl_xor_sync(kFullMask, delta, off);

  if (lane == 0) {
    bool down = false;
    if (samples > 0) {
      const int64_t n1 = samples - 1;
      down = !(v[n1] != 0 && s[n1] >= 1);
    }
    int64_t* o = out + row * 5;
    o[0] = drops;
    o[1] = flaps;
    o[2] = down ? 1 : 0;
    o[3] = samples;
    o[4] = static_cast<int64_t>(delta);
  }
}

}  // namespace

// Launches the scan on `stream`. All pointers are device pointers to
// contiguous row-major [L, T] inputs and an [L, 5] output; 0 < L and
// 0 < T < 2^31 are checked by the caller. Returns cudaGetLastError().
extern "C" int gpud_packed_scan(const void* states, const void* counters,
                                const void* valid, int64_t L, int64_t T,
                                void* out, void* stream) {
  const uintptr_t bases = reinterpret_cast<uintptr_t>(states) |
                          reinterpret_cast<uintptr_t>(counters) |
                          reinterpret_cast<uintptr_t>(valid);
  const int64_t blocks = (L + kWarpsPerBlock - 1) / kWarpsPerBlock;
  packed_scan_kernel<<<static_cast<unsigned>(blocks), kThreadsPerBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(states), static_cast<const int32_t*>(counters),
      static_cast<const uint8_t*>(valid), L, T, (bases & 15) == 0 ? 1 : 0,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
