// numpy's float32 uniform draw from a PCG64 stream, on the card: the ALS
// fit's starting factor table (models/als.py:_initial_factors) as
//
//   random_state.random((n, F), dtype=np.float32) * np.float32(0.01)
//
// rounded to the model's storage dtype gives it on the host, bit for bit,
// written once in float32 (the solve dtype of every storage but float64).
//
// Replaces no TPU kernel: the JAX package draws its starting tables with
// numpy on the host and uploads them, as the port did; on one host thread
// that draw was the largest single step of a default fit.
//
// numpy's stream (numpy/random/src/pcg64): the 128-bit state s steps
// s <- A s + inc (mod 2^128), and each step gives the 64-bit output
// rotr64(hi ^ lo, hi >> 58) of the new state. A float32 takes 32 bits: the
// low half of a fresh output, whose high half the generator keeps
// (has_uint32, uinteger) for the next float; the float is (u >> 8) * 2^-24.
// So element i of a draw that starts with no kept half is the low (i even)
// or high (i odd) half of output i / 2; a draw that starts with a kept half
// takes it as element 0 and everything else one element later.
// ops/pcg64.py sets the generator's state after the draw, as numpy leaves it.
//
// Bound: the bytes written, 4 per element (0.055 ms for the 358,868 x 128
// table at 3.35 TB/s); the integer work, two 128-bit multiply-adds per pair
// of elements on the 32-bit multipliers, is of the same order. So:
//
// - Thread t of T writes element pairs (2p, 2p + 1) for p = t, t + T, ...,
//   one 8-byte store each, so a warp's stores are 256 contiguous bytes.
// - It reaches S_t, the state t steps on, by the binary jump ahead (the map
//   (A^t, C_t) in at most log2(T) squarings), then steps T pairs at a time
//   by the map (A^T, C_T), computed once on the host by the same function.
//   Pair p takes output p (the state S_{p+1}), and with a kept half also
//   output p - 1's high half (the state S_p it holds).
// - The scale is one float32 multiply (__fmul_rn, no contraction), the
//   rounding to bfloat16 or float16 to nearest even, as torch's casts.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pcg {

constexpr int kThreads = 256;

struct U128 {
  uint64_t hi, lo;
};

// numpy's PCG64 multiplier, PCG_DEFAULT_MULTIPLIER_128 (scalars: a constant
// of a class type is not visible in device code)
constexpr uint64_t kMultHi = 2549297995355413924ull, kMultLo = 4865540595714422341ull;

__host__ __device__ __forceinline__ uint64_t mul_hi(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
#endif
}

// a b and a + b mod 2^128
__host__ __device__ __forceinline__ U128 mul(U128 a, U128 b) {
  return {mul_hi(a.lo, b.lo) + a.lo * b.hi + a.hi * b.lo, a.lo * b.lo};
}

__host__ __device__ __forceinline__ U128 add(U128 a, U128 b) {
  const uint64_t lo = a.lo + b.lo;
  return {a.hi + b.hi + (lo < a.lo), lo};
}

// (mult, plus) with mult s + plus = k steps of s <- a s + c from s
__host__ __device__ inline void jump(uint64_t k, U128 a, U128 c, U128& mult, U128& plus) {
  mult = {0, 1};
  plus = {0, 0};
  while (k) {
    if (k & 1) {
      mult = mul(mult, a);
      plus = add(mul(plus, a), c);
    }
    c = mul(add(a, U128{0, 1}), c);
    a = mul(a, a);
    k >>= 1;
  }
}

// XSL-RR: the output of the state s
__device__ __forceinline__ uint64_t output(U128 s) {
  const uint64_t x = s.hi ^ s.lo;
  const unsigned r = (unsigned)(s.hi >> 58);
  return (x >> r) | (x << ((64 - r) & 63));
}

// the stored value of the 32 bits u: storage 0 float32, 1 bfloat16, 2 float16
template <int kStorage>
__device__ __forceinline__ float value(uint32_t u) {
  const float f = __fmul_rn((float)(u >> 8) * 5.9604644775390625e-8f, 0.01f);  // 2^-24, exact
  if (kStorage == 1) return __bfloat162float(__float2bfloat16_rn(f));
  if (kStorage == 2) return __half2float(__float2half_rn(f));
  return f;
}

template <int kStorage>
__global__ void __launch_bounds__(kThreads)
    pcg64_uniform_kernel(U128 s0, U128 inc, U128 step_mult, U128 step_plus, long long n,
                         int buffered, uint32_t kept, float* __restrict__ out) {
  const long long pairs = (n + 1) / 2;
  const long long stride = (long long)gridDim.x * kThreads;
  long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= pairs) return;
  const U128 a = {kMultHi, kMultLo};
  U128 mult, plus;
  jump((uint64_t)p, a, inc, mult, plus);
  U128 s = add(mul(mult, s0), plus);  // S_p
  for (; p < pairs; p += stride) {
    const U128 next = add(mul(a, s), inc);  // S_{p+1}
    const uint64_t x = output(next);
    uint32_t u0 = (uint32_t)x, u1 = (uint32_t)(x >> 32);
    if (buffered) {
      u1 = u0;
      u0 = p == 0 ? kept : (uint32_t)(output(s) >> 32);
    }
    const float v0 = value<kStorage>(u0);
    if (2 * p + 1 < n) {
      reinterpret_cast<float2*>(out)[p] = make_float2(v0, value<kStorage>(u1));
    } else {
      out[2 * p] = v0;
    }
    s = add(mul(step_mult, s), step_plus);
  }
}

}  // namespace pcg

// n float32 values into out (8-byte aligned) from the PCG64 state
// (state_hi, state_lo) and increment (inc_hi, inc_lo), the first of them the
// kept half `kept` where buffered != 0; storage 0 float32, 1 bfloat16, 2
// float16; `blocks` blocks of 256 threads. Returns the launch's cudaError_t
// (0 on success).
extern "C" int pcg64_uniform(uint64_t state_hi, uint64_t state_lo, uint64_t inc_hi,
                             uint64_t inc_lo, long long n, int buffered, uint32_t kept,
                             void* out, int storage, int blocks, void* stream) {
  using namespace pcg;
  if (n < 0 || blocks < 1 || storage < 0 || storage > 2) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)out % 8) return (int)cudaErrorMisalignedAddress;
  if (n == 0) return (int)cudaSuccess;
  const U128 s0 = {state_hi, state_lo}, inc = {inc_hi, inc_lo};
  U128 step_mult, step_plus;
  jump((uint64_t)blocks * kThreads, U128{kMultHi, kMultLo}, inc, step_mult, step_plus);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const int b = buffered != 0;
  switch (storage) {
    case 1:
      pcg64_uniform_kernel<1><<<blocks, kThreads, 0, st>>>(s0, inc, step_mult, step_plus, n, b,
                                                           kept, o);
      break;
    case 2:
      pcg64_uniform_kernel<2><<<blocks, kThreads, 0, st>>>(s0, inc, step_mult, step_plus, n, b,
                                                           kept, o);
      break;
    default:
      pcg64_uniform_kernel<0><<<blocks, kThreads, 0, st>>>(s0, inc, step_mult, step_plus, n, b,
                                                           kept, o);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* als_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
