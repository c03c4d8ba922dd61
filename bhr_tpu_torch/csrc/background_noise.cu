// Background noise of the lifecycle disk for NVIDIA Hopper (sm_90a): the
// 13 simplex/FBM fields of bhr_tpu_torch/ops/background.py and their
// combination into the 7 background planes, in one kernel.
//
// Replaces no Pallas kernel. bhr_tpu computes this pass as plain jnp
// (bhr_tpu/ops/background.py: generate_background_components), and XLA
// fuses the element-wise graph under jit on the TPU. Run eagerly by
// PyTorch, every multiply, add, where, shift and compare of the 42
// simplex evaluations a texel is a launch of its own: ~10,630 launches
// a pass whether it covers 1 frame or 4, paid by the host at every
// session step and every video batch. This kernel is the pass as one
// launch. Its plain version, in the same module, is
// generate_background_components_plain; the wrapper sends a CPU tensor
// there and a CUDA tensor here, with no fallback.
//
// What bounds it on this card: operations, the integer ones likely
// first; bytes only at 4K. A point of the generation grid reads nothing
// (its coordinates come from its index, the table and the times from
// the kernel's parameters) and writes its 7 values s x s times, 28 bytes
// x s^2: 33.9 MB a frame at FHD (2912 x 416, s = 2), ~10 us at
// 3.35 TB/s, and 136 MB at 4K (5824 x 832, s = 4), ~41 us. Its 42
// simplex evaluations are 3,788 FP32 operations a point, 1.15 G a frame
// over the 302,848 points of the 208 x 1456 grid that FHD and 4K share:
// ~34 us at one operation a lane and a clock on 132 SMs x 128 lanes,
// since none of them can fuse into an FMA and keep the plain version's
// rounding. Beside them the lattice hash (four a simplex evaluation),
// the gradient pick and the corner offsets are ~2,800 int32 operations a
// point in the plain version, on half as many INT32 lanes: ~51 us if
// none fused, less where a multiply-add is one IMAD or an xor-and one
// LOP3; the float/int conversions and the selects come on top. The
// plain pass costs ~100 ms of host dispatch for the same frames.
//
// Design:
//  * One thread per (frame, r, phi) point; a warp covers 32 neighbouring
//    phi of one r. The thread computes r, phi, omega(r), phi_rot and
//    cos/sin once, then the 13 fields and their combination in
//    registers: nothing is read from device memory.
//  * The 13 fields' coefficients are ops/background.py's NOISE_FIELDS,
//    passed with the times in one parameter struct by value
//    (__grid_constant__: read from the constant bank, uniform across the
//    warp, never copied to local memory). The times go by value so that
//    no host-to-device copy sits between this launch and the one before;
//    the wrapper launches again for each MAX_FRAMES frames.
//  * The output is folded into the store: each thread writes its s x s
//    block of each of the 7 planes (the two zero spiral planes and
//    0.05 * turb included) straight into the (F, 7, n_r, n_phi) result,
//    as the plain version's stack and two repeat_interleave calls lay it
//    out; with s = 2 or 4 a row of the block is one float2 or float4
//    store, and a warp's stores of a row are contiguous.
//  * Bit-equal to the plain version on the card. Each operation rounds
//    where PyTorch's eager kernel rounds: __fmul_rn / __fadd_rn /
//    __fsub_rn everywhere (nvcc's -fmad=true, kept for the ray march,
//    would otherwise fuse a product into the add after it), libdevice
//    cosf / sinf / powf / floorf without fast math (PyTorch's kernels
//    call the same functions), correctly rounded __frcp_rn and
//    __fsqrt_rn (torch's 0.5 / x is x.reciprocal() * 0.5, its sqrt is
//    IEEE), the grid's x / n as x * fl(1/n) (torch divides a CUDA tensor
//    by a Python number that way; the wrapper passes fl(1/n)), clamp as
//    torch's (NaN passes through). The int32 lattice hash wraps: the
//    products are taken in uint32_t (signed overflow is undefined in
//    C++) and reinterpreted, the right shifts are arithmetic on int32_t,
//    which is XLA's and torch's int32 arithmetic. Constants are the
//    plain version's Python doubles rounded to float (F32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFields = 13;      // len(NOISE_FIELDS)
constexpr int kMaxOctaves = 5;   // MAX_OCTAVES
constexpr int kMaxFrames = 16;   // MAX_FRAMES
constexpr int kPlanes = 7;       // PLANES
constexpr int kBlock = 256;

// Indices into Params::field (ops/background.py NOISE_FIELDS):
// TEMP_BASE, TURBULENCE (6), AZ_HOTSPOT, DISTURB (5).
constexpr int kTempBase = 0;
constexpr int kTurb0 = 1, kTurbN = 6;
constexpr int kAzHotspot = 7;
constexpr int kDisturb0 = 8, kDisturbN = 5;

// ops/background.py NoiseField, with fbm_3d's octave amplitudes as
// Python computes them in double (amplitude *= persistence), rounded.
struct Field {
  float xy, r_freq, t_coef, weight;
  float amp[kMaxOctaves];
  int octaves;  // 0: one simplex evaluation clamped to [0, 1]
};

// ops/background.py KernelParams (checked by size at load).
struct Params {
  Field field[kFields];
  float time[kMaxFrames];
  float az_freq, az_shear, r_inner, r_outer;
  float inv_n_r, inv_n_phi;  // fl(1 / n_r), fl(1 / n_phi)
  int n_r, n_phi, scale, frames;
};

// Constants written as double literals rounded to float: the plain
// version's Python scalars are doubles that torch rounds the same way.
#define F32(x) static_cast<float>(x)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.clamp / clamp_min on CUDA: NaN passes through.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// ops/background.py _unit: clamp(0.5 + 0.5 * v, 0, 1).
__device__ __forceinline__ float unit(float v) {
  return clamp(add(mul(v, 0.5f), 0.5f), 0.0f, 1.0f);
}

// ops/noise.py _hash3: int32 multiply-xorshift mix.
__device__ __forceinline__ int32_t hash3(int32_t i, int32_t j, int32_t k) {
  uint32_t h = static_cast<uint32_t>(i) * 374761393u +
               static_cast<uint32_t>(j) * 668265263u +
               static_cast<uint32_t>(k) * 1440662683u;
  h = (h ^ static_cast<uint32_t>(static_cast<int32_t>(h) >> 13)) * 1274126177u;
  h = h ^ static_cast<uint32_t>(static_cast<int32_t>(h) >> 16);
  return static_cast<int32_t>(h & 0x7FFFFFFFu);
}

// ops/noise.py _grad3_dot.
__device__ __forceinline__ float grad3_dot(int32_t h, float x, float y, float z) {
  h &= 15;
  const float u = h < 8 ? x : y;
  const float v = h < 4 ? y : ((h == 12 || h == 14) ? x : z);
  return add((h & 1) == 0 ? u : -u, (h & 2) == 0 ? v : -v);
}

// ops/noise.py simplex_noise_3d's corner(0.6 - x^2 - y^2 - z^2, ...).
__device__ __forceinline__ float corner(float x, float y, float z, int32_t gi) {
  const float t = clamp_min(
      sub(sub(sub(F32(0.6), mul(x, x)), mul(y, y)), mul(z, z)), 0.0f);
  const float t2 = mul(t, t);
  return mul(mul(t2, t2), grad3_dot(gi, x, y, z));
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// ops/noise.py simplex_noise_3d: Gustavson 3D simplex noise.
__device__ __forceinline__ float simplex(float x, float y, float z) {
  constexpr float kF3 = F32(1.0 / 3.0);
  constexpr float kG3 = F32(1.0 / 6.0);
  constexpr float kG3x2 = F32(2.0 * (1.0 / 6.0));
  constexpr float kG3x3 = F32(3.0 * (1.0 / 6.0));

  const float s = mul(add(add(x, y), z), kF3);
  const int32_t i = static_cast<int32_t>(floorf(add(x, s)));
  const int32_t j = static_cast<int32_t>(floorf(add(y, s)));
  const int32_t k = static_cast<int32_t>(floorf(add(z, s)));

  const float t = mul(static_cast<float>(wrap_add(wrap_add(i, j), k)), kG3);
  const float x0 = sub(x, sub(static_cast<float>(i), t));
  const float y0 = sub(y, sub(static_cast<float>(j), t));
  const float z0 = sub(z, sub(static_cast<float>(k), t));

  const bool a = x0 >= y0, b = y0 >= z0, c = x0 >= z0;
  const int i1 = a && (b || c), j1 = !a && b, k1 = !b && !(a && c);
  const int i2 = a || (b && c), j2 = !a || b, k2 = !b || (!a && !c);

  const float x1 = add(sub(x0, static_cast<float>(i1)), kG3);
  const float y1 = add(sub(y0, static_cast<float>(j1)), kG3);
  const float z1 = add(sub(z0, static_cast<float>(k1)), kG3);
  const float x2 = add(sub(x0, static_cast<float>(i2)), kG3x2);
  const float y2 = add(sub(y0, static_cast<float>(j2)), kG3x2);
  const float z2 = add(sub(z0, static_cast<float>(k2)), kG3x2);
  const float x3 = add(sub(x0, 1.0f), kG3x3);
  const float y3 = add(sub(y0, 1.0f), kG3x3);
  const float z3 = add(sub(z0, 1.0f), kG3x3);

  const float n0 = corner(x0, y0, z0, hash3(i, j, k));
  const float n1 = corner(x1, y1, z1,
                          hash3(wrap_add(i, i1), wrap_add(j, j1), wrap_add(k, k1)));
  const float n2 = corner(x2, y2, z2,
                          hash3(wrap_add(i, i2), wrap_add(j, j2), wrap_add(k, k2)));
  const float n3 = corner(x3, y3, z3,
                          hash3(wrap_add(i, 1), wrap_add(j, 1), wrap_add(k, 1)));
  return mul(add(add(add(n0, n1), n2), n3), F32(32.0));
}

// ops/background.py _noise: one field at the rotating coordinates. The
// octave loop stays rolled (one simplex body per field in the code);
// f.amp[o] is then a load from the parameter bank by index.
__device__ __forceinline__ float noise_field(const Field& f, float cx, float cy,
                                             float r, float t) {
  const float x = mul(cx, f.xy), y = mul(cy, f.xy);
  const float z = add(mul(r, f.r_freq), mul(t, f.t_coef));
  float v;
  if (f.octaves > 0) {
    // ops/noise.py fbm_3d: value = 0.0; value += amplitude * simplex(x *
    // freq, ...), freq = 1, 2, 4, ... (exact in float).
    float value = 0.0f, freq = 1.0f;
#pragma unroll 1
    for (int o = 0; o < f.octaves; ++o) {
      value = add(value, mul(simplex(mul(x, freq), mul(y, freq), mul(z, freq)),
                             f.amp[o]));
      freq = mul(freq, 2.0f);
    }
    v = unit(value);
  } else {
    v = clamp(simplex(x, y, z), 0.0f, 1.0f);
  }
  return mul(v, f.weight);
}

// An s x s block of one plane at `dst` (row stride n_phi floats): a row
// is one vector store where s is 2 or 4 (dst is then aligned to it).
__device__ __forceinline__ void store_block(float* dst, float v, int s, int n_phi) {
  if (s == 1) {
    *dst = v;
  } else if (s == 2) {
#pragma unroll
    for (int y = 0; y < 2; ++y)
      *reinterpret_cast<float2*>(dst + static_cast<int64_t>(y) * n_phi) = make_float2(v, v);
  } else if (s == 4) {
#pragma unroll
    for (int y = 0; y < 4; ++y)
      *reinterpret_cast<float4*>(dst + static_cast<int64_t>(y) * n_phi) =
          make_float4(v, v, v, v);
  } else {
    for (int y = 0; y < s; ++y)
      for (int x = 0; x < s; ++x) dst[static_cast<int64_t>(y) * n_phi + x] = v;
  }
}

__global__ void __launch_bounds__(kBlock)
background_noise(const __grid_constant__ Params p, float* __restrict__ out) {
  const int s = p.scale;
  const int gr = p.n_r / s, gp = p.n_phi / s;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= static_cast<int64_t>(p.frames) * gr * gp) return;
  const int ip = static_cast<int>(idx % gp);
  const int64_t rest = idx / gp;
  const int ir = static_cast<int>(rest % gr);
  const int frame = static_cast<int>(rest / gr);

  // The grid: arange * s / n (times 2 pi for phi), each step rounded.
  const float r = mul(static_cast<float>(ir * s), p.inv_n_r);
  const float phi = mul(mul(static_cast<float>(ip * s), p.inv_n_phi),
                        F32(2.0 * 3.141592653589793));
  const float t = p.time[frame];

  // ops/shading.py keplerian_omega: sqrt(0.5 / (r^3 + 1e-6)).
  const float r_phys = add(p.r_inner, mul(sub(p.r_outer, p.r_inner), r));
  const float r3 = mul(mul(r_phys, r_phys), r_phys);
  const float omega = __fsqrt_rn(mul(__frcp_rn(add(r3, F32(1e-6))), 0.5f));
  const float phi_rot = add(phi, mul(omega, t));
  const float cx = cosf(phi_rot);
  const float cy = sinf(phi_rot);

  const float decay = powf(clamp_min(sub(1.0f, r), 0.0f), F32(1.3));
  const float tb = noise_field(p.field[kTempBase], cx, cy, r, t);
  const float temp_base = mul(mul(decay, add(mul(tb, F32(0.15)), F32(0.85))), 0.25f);

  float turb = noise_field(p.field[kTurb0], cx, cy, r, t);
#pragma unroll
  for (int k = kTurb0 + 1; k < kTurb0 + kTurbN; ++k)
    turb = add(turb, noise_field(p.field[k], cx, cy, r, t));
  turb = clamp(turb, 0.0f, 1.0f);

  const float shear = mul(powf(r, F32(1.2)), p.az_shear);
  const float az_wave =
      add(mul(sinf(mul(add(phi_rot, shear), p.az_freq)), 0.5f), 0.5f);
  const float az_hotspot = mul(az_wave, noise_field(p.field[kAzHotspot], cx, cy, r, t));

  float disturb = noise_field(p.field[kDisturb0], cx, cy, r, t);
#pragma unroll
  for (int k = kDisturb0 + 1; k < kDisturb0 + kDisturbN; ++k)
    disturb = add(disturb, noise_field(p.field[k], cx, cy, r, t));
  disturb = clamp(mul(disturb, F32(1.4)), F32(0.05), 1.0f);
  disturb = clamp(mul(disturb, add(mul(r, F32(0.4)), F32(0.6))), F32(0.1), 1.0f);

  const float planes[kPlanes] = {temp_base, 0.0f, 0.0f, turb,
                                 mul(turb, F32(0.05)), az_hotspot, disturb};
  const int64_t plane = static_cast<int64_t>(p.n_r) * p.n_phi;
  float* dst = out + static_cast<int64_t>(frame) * kPlanes * plane +
               static_cast<int64_t>(ir) * s * p.n_phi + static_cast<int64_t>(ip) * s;
#pragma unroll
  for (int q = 0; q < kPlanes; ++q) store_block(dst + q * plane, planes[q], s, p.n_phi);
}

}  // namespace

// Launch on `stream` over params->frames frames, writing the
// (frames, 7, n_r, n_phi) float32 block at `out`; returns the
// cudaError_t of the launch and does not synchronize.
extern "C" int bhr_background_noise(const void* params, void* out, void* stream) {
  const Params p = *static_cast<const Params*>(params);
  if (p.scale < 1 || p.n_r < p.scale || p.n_phi < p.scale || p.n_r % p.scale ||
      p.n_phi % p.scale || p.frames < 1 || p.frames > kMaxFrames)
    return cudaErrorInvalidValue;
  for (int k = 0; k < kFields; ++k)
    if (p.field[k].octaves < 0 || p.field[k].octaves > kMaxOctaves)
      return cudaErrorInvalidValue;
  const int64_t points =
      static_cast<int64_t>(p.frames) * (p.n_r / p.scale) * (p.n_phi / p.scale);
  const int64_t blocks = (points + kBlock - 1) / kBlock;
  if (blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  background_noise<<<static_cast<unsigned>(blocks), kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(p, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Constants the wrapper checks against its own, so the two layouts
// cannot drift apart silently.
extern "C" int bhr_background_noise_layout(int which) {
  switch (which) {
    case 0: return static_cast<int>(sizeof(Params));
    case 1: return kFields;
    case 2: return kMaxOctaves;
    case 3: return kMaxFrames;
    case 4: return kPlanes;
    default: return -1;
  }
}
