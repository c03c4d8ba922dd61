// Ray-march kernel for NVIDIA Hopper (sm_90a): per-ray RK4 integration
// of Schwarzschild null geodesics with disk-plane hit recording.
//
// Replaces bhr_tpu/ops/geodesic_pallas.py: build_ray_march_kernel, in
// the static variants the still frame uses, as one template
// ray_march<kDiff, kRecord, kSteps> compiled once:
//   slim    (with_differentials=False, record_hits=True)  default frame
//   aa      (with_differentials=True,  record_hits=True)  anti-aliased
//   nodisk  (record_hits=False)                           no disk texture
// and each of the three with record_step_counts=True (a per-ray step
// count). Every instantiation traces a row band (row_start, row_count)
// of the frame: rows [row0, row0 + rows) of a height-row image plane,
// the whole frame when row0 = 0 and rows = height. The plain PyTorch
// version it is checked against is bhr_tpu_torch/ops/geodesic.py:
// trace_geodesics.
//
// What bounds it on this card: instruction issue. A ray reads nothing
// and writes its result once, 210 bytes (hits 4x12 floats, escape
// direction, flags, count): 0.44 GB for a 1920x1080 frame, 0.13 ms at
// 3.35 TB/s against ~1 ms of arithmetic. Each RK4 step is a dependent
// chain of ~120-140 FP32 instructions on state held in registers (the
// AA variant's two Jacobian-transported differentials add ~225), and
// neighbouring rays take similar step counts (a warp's lanes are ~99%
// busy at FHD), so what the SM can issue — 4 warp instructions per
// clock, 16 MUFU lanes (rsqrt, rcp, the seeds of sqrt and divide) — is
// the limit. chip_smoke.py counts the fewest SASS instructions a step
// issues (the loop's shortest way from head to back-branch) and prints
// this issue bound beside the FP32-operation bound; the divide form of
// earlier versions (IEEE '/' and sqrtf, built with -fmad=false) issued
// 2.1-2.2x the instructions per step of this one (PERF.md).
//
// Design:
//  * Divide-free arithmetic, as the Pallas kernel computes it
//    (geodesic_pallas.py:284-347): one rsqrt per RK4 stage gives both
//    r^-5 (the acceleration factor) and r^-2 (reused by the Jacobian);
//    the adaptive step is rs * min(rsqrt(r^2), 1/(rs + 1e-3)) with the
//    stage-1 rsqrt, sqrt(r_safe / rs) as a multiply by 1/rs, and one
//    reciprocal; the updates multiply by 1/6; rays and the escape
//    direction are normalised by x * rsqrt(|x|^2 + 1e-18). An IEEE
//    divide or square root is a MUFU seed plus a few FFMAs and a
//    slow-path test; rsqrt.approx.ftz is one MUFU instruction. What is
//    left: two correctly rounded square roots and one reciprocal per
//    step, one reciprocal per recorded crossing (t_frac). The source
//    names each: rsqrt_approx (PTX rsqrt.approx.ftz.f32), __fsqrt_rn and
//    __frcp_rn (correctly rounded), so no global flag changes them.
//  * The AA variant's initial differentials are the Pallas kernel's
//    one-pixel direction deltas, normalize(a) - normalize(v), written
//    without that subtraction of two unit vectors (pixel_delta): each
//    carries ~1e-7 of rounding, which is ~1e-4 of a 4K pixel's angle,
//    and kernel and plain version round it differently, so their p99
//    relative difference grew with the resolution past 1e-3 (PERF.md).
//  * Multiply-adds fuse into FFMA (nvcc's default -fmad=true), which
//    halves the instructions of the RK4 sums and the stage positions.
//    The kernel therefore no longer matches its plain version bit for
//    bit; the checks (bhr_tpu_torch/ops/trace_compare.py) hold the two
//    to bhr_tpu's Pallas-vs-JAX bounds (exact categories and step counts
//    at the parity scenes, 2e-3 on positions and directions, 5e-3 on the
//    differentials) and to the port's own: at most 0.1% of rays flipping
//    at full size, a 1e-3 p99 relative bound on the differentials.
//  * Registers: state, four stages and (AA) two differentials live in
//    registers with no spill (ptxas's count per instantiation is in
//    PERF.md); asking ptxas for more resident blocks per SM moved FHD
//    times by no more than their spread between runs.
//  * One thread per pixel; each thread loops until its ray is captured,
//    escapes or reaches max_iter. The TPU kernel's tile-wide early exit,
//    unrolled exit checks, float mask carries and two-phase fat/slim loop
//    only shaped the TPU's lock-step vector loop and do not change
//    results, so none of them is here: the AA variant transports its
//    differentials on every step of a live ray.
//  * Blocks are 8 x 16 pixels, so each warp is an 8 x 4 patch of the
//    image rather than a 32-pixel row segment. Long-running rays cluster
//    in a thin annulus around the photon ring; a compact patch keeps a
//    warp's rays similar in length, which limits divergence.
//  * Slim: the K = 4 hit slots x 5 features stay in registers (K is a
//    compile-time constant and every slot index is unrolled). AA: 4 x 12
//    features would spill, and a slot is written exactly once (when
//    count == k), so a recorded crossing goes straight to `hits` in
//    global memory and the unwritten slots are zeroed at the end.
//  * Outputs are written straight into TraceResult's layout (no padding,
//    no crop), over the band's N = rows x width rays: captured/escaped
//    (N,) bytes, escape_dir (N,3), hit_count (N,) int32, hits (K,12,N),
//    steps (N,) int32. The slim variant leaves features 5..11 zero (as
//    the Pallas slim kernel; its plain version writes t_frac at 11), the
//    AA variant writes all 12 (t_frac at 11). The wrapper allocates
//    them; the kernel allocates nothing. Every scalar that Python derives
//    in double (squares, 1/rs, 1/(rs + 1e-3), 40*r_escape, tan(tilt))
//    arrives precomputed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 4;        // MAX_DISK_CROSSINGS
constexpr int kFeatures = 12;    // HIT_FEATURES
constexpr int kBlockX = 8;
constexpr int kBlockY = 16;
constexpr int kNumVariants = 6;  // C entry points below

// Float parameter layout (bhr_tpu_torch/ops/geodesic_cuda.py _FPARAMS).
enum FParam {
  kHBase = 0, kRs, kRFloor, kInvRs, kInvRFloor, kRs2, kREscape2,
  kMaxAffine, kTanT, kRIn2, kROut2, kNumFParams
};
// Int parameter layout (_IPARAMS).
// kHeight is the full frame's height (it sets the image plane), kRows the
// band's row count (it sets the grid and the output size), kRow0 the
// band's first pixel row.
enum IParam { kWidth = 0, kHeight, kRow0, kRows, kMaxIter, kNumIParams };

struct Params {
  float f[kNumFParams];
  int i[kNumIParams];
};

// Constants written as double literals rounded to float: the plain
// version's Python scalars are doubles that torch rounds the same way.
#define F32(x) static_cast<float>(x)

// rsqrt.approx.ftz: one MUFU.RSQ (max relative error 2^-22.9). rsqrtf()
// adds four instructions to rescale a denormal input, and no input here
// is one: a squared norm plus 1e-18, or the squared radius of an RK4
// stage, which stays near 1 or above (the horizon) — FLT_MIN is 1.2e-38.
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x * rsqrt(|x|^2 + 1e-18): the Pallas kernel's _normalize3.
__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = rsqrt_approx(x * x + y * y + z * z + F32(1e-18));
  x *= inv;
  y *= inv;
  z *= inv;
}

// Image plane 1 unit ahead of the camera, from the 14 camera floats
// (bhr_tpu_torch.ops.geodesic._image_plane).
struct ImagePlane {
  float cx, cy, cz, rx, ry, rz, ux, uy, uz, pw, ph, tlx, tly, tlz;

  // Unnormalised ray from the camera through the centre of pixel
  // (col, row).
  __device__ __forceinline__ void ray(float col, float row, float& vx,
                                      float& vy, float& vz) const {
    const float a = (col + F32(0.5)) * pw;
    const float b = (row + F32(0.5)) * ph;
    vx = tlx + a * rx - b * ux - cx;
    vy = tly + a * ry - b * uy - cy;
    vz = tlz + a * rz - b * uz - cz;
  }
};

// normalize(v + d) - normalize(v) for the unnormalised ray v with iv =
// 1/|v| and a one-pixel step d on the image plane, without subtracting
// two unit vectors (bhr_tpu_torch.ops.geodesic._pixel_delta):
//   d ia - v (ia - iv),  ia - iv = -(d.(2v + d)) (ia iv)^2 / (ia + iv).
// Each term is of the size of the result (~a pixel's angle, 1e-3 at
// FHD), so its rounding error is a few ulp of the result rather than of
// the unit vectors.
__device__ __forceinline__ void pixel_delta(const float* v, float iv,
                                            const float* d, float* out) {
  const float a0 = v[0] + d[0], a1 = v[1] + d[1], a2 = v[2] + d[2];
  const float ia = rsqrt_approx(a0 * a0 + a1 * a1 + a2 * a2);
  const float s = d[0] * (v[0] + a0) + d[1] * (v[1] + a1) + d[2] * (v[2] + a2);
  const float ii = ia * iv;
  const float g = s * (ii * ii) * __frcp_rn(ia + iv);
#pragma unroll
  for (int c = 0; c < 3; ++c) out[c] = d[c] * ia - v[c] * g;
}

// An RK4 stage position with 1/r, its factor f = -1.5 L^2 / r^5 and
// 1/r^2, all from one rsqrt (geodesic_pallas.py:303-312).
struct Stage {
  float x, y, z, ir, f, inv_r2;

  __device__ __forceinline__ Stage(float sx, float sy, float sz,
                                   float neg15_l2)
      : x(sx), y(sy), z(sz), ir(rsqrt_approx(sx * sx + sy * sy + sz * sz)) {
    inv_r2 = ir * ir;
    f = neg15_l2 * (inv_r2 * inv_r2 * ir);
  }
};

// h * J(s) d = h * f (d - 5 s (s.d) / r^2): the acceleration's Jacobian
// applied to a position differential, with the stage's own f and 1/r^2.
__device__ __forceinline__ void h_jac(float h, const Stage& s,
                                      const float* d, float* out) {
  const float proj = (s.x * d[0] + s.y * d[1] + s.z * d[2]) * s.inv_r2;
  out[0] = h * (s.f * (d[0] - (F32(5.0) * s.x) * proj));
  out[1] = h * (s.f * (d[1] - (F32(5.0) * s.y) * proj));
  out[2] = h * (s.f * (d[2] - (F32(5.0) * s.z) * proj));
}

// One RK4 step of a ray differential (dp, dd) = (d_pos, d_dir) at the
// main ray's four stage positions (bhr_tpu/ops/geodesic.py:119-133).
__device__ __forceinline__ void diff_rk4(float h, const Stage* st,
                                         const float* dp, const float* dd,
                                         float* ndp, float* ndd) {
  const float sixth = F32(1.0 / 6.0), two = F32(2.0), half = F32(0.5);
  float q1p[3], q1d[3], q2p[3], q2d[3], q3p[3], q3d[3], q4p[3], q4d[3];
  float t[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) q1p[c] = h * dd[c];
  h_jac(h, st[0], dp, q1d);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q2p[c] = h * (dd[c] + half * q1d[c]);
    t[c] = dp[c] + half * q1p[c];
  }
  h_jac(h, st[1], t, q2d);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q3p[c] = h * (dd[c] + half * q2d[c]);
    t[c] = dp[c] + half * q2p[c];
  }
  h_jac(h, st[2], t, q3d);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q4p[c] = h * (dd[c] + q3d[c]);
    t[c] = dp[c] + q3p[c];
  }
  h_jac(h, st[3], t, q4d);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    ndp[c] = dp[c] + (q1p[c] + two * q2p[c] + two * q3p[c] + q4p[c]) * sixth;
    ndd[c] = dd[c] + (q1d[c] + two * q2d[c] + two * q3d[c] + q4d[c]) * sixth;
  }
}

template <bool kDiff, bool kRecord, bool kSteps>
__global__ void __launch_bounds__(kBlockX * kBlockY)
ray_march(Params p, const float* __restrict__ cam,
          uint8_t* __restrict__ captured, uint8_t* __restrict__ escaped,
          float* __restrict__ escape_dir, int32_t* __restrict__ hit_count,
          float* __restrict__ hits, int32_t* __restrict__ steps) {
  static_assert(kRecord || !kDiff,
                "differentials are read only at a recorded crossing");
  const int width = p.i[kWidth];
  const int rows = p.i[kRows];
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= width || y >= rows) return;
  const int64_t n = static_cast<int64_t>(y) * width + x;
  const int64_t n_rays = static_cast<int64_t>(rows) * width;

  // Primary ray (bhr_tpu_torch.ops.geodesic.primary_rays_from_params).
  ImagePlane plane;
  plane.cx = cam[0]; plane.cy = cam[1]; plane.cz = cam[2];
  plane.rx = cam[3]; plane.ry = cam[4]; plane.rz = cam[5];
  plane.ux = cam[6]; plane.uy = cam[7]; plane.uz = cam[8];
  const float fx = cam[9], fy = cam[10], fz = cam[11];
  plane.pw = cam[12]; plane.ph = cam[13];
  // The image plane is the full frame's; a band only offsets its pixel
  // rows by row0 (geodesic_pallas.py:145-155).
  const float half_w = plane.pw * static_cast<float>(width) * F32(0.5);
  const float half_h = plane.ph * static_cast<float>(p.i[kHeight]) * F32(0.5);
  plane.tlx = plane.cx + fx - plane.rx * half_w + plane.ux * half_h;
  plane.tly = plane.cy + fy - plane.ry * half_w + plane.uy * half_h;
  plane.tlz = plane.cz + fz - plane.rz * half_w + plane.uz * half_h;
  const float col = static_cast<float>(x);
  const float row = static_cast<float>(y + p.i[kRow0]);

  float px = plane.cx, py = plane.cy, pz = plane.cz;
  float ray[3];
  plane.ray(col, row, ray[0], ray[1], ray[2]);
  const float iv = rsqrt_approx(ray[0] * ray[0] + ray[1] * ray[1] +
                                ray[2] * ray[2] + F32(1e-18));
  float vx = ray[0] * iv, vy = ray[1] * iv, vz = ray[2] * iv;
  // L = dir x pos, conserved along the ray.
  const float lx = vy * pz - vz * py;
  const float ly = vz * px - vx * pz;
  const float lz = vx * py - vy * px;
  const float neg15_l2 = F32(-1.5) * (lx * lx + ly * ly + lz * lz);

  // Ray differentials (AA): d_pos = 0, d_dir = the one-pixel direction
  // delta, per pixel axis (primary_differentials_from_params): one
  // column right is + pw * right, one row down - ph * up.
  float dxp[3] = {0.0f, 0.0f, 0.0f}, dxd[3] = {0.0f, 0.0f, 0.0f};
  float dyp[3] = {0.0f, 0.0f, 0.0f}, dyd[3] = {0.0f, 0.0f, 0.0f};
  if constexpr (kDiff) {
    const float step_x[3] = {plane.pw * plane.rx, plane.pw * plane.ry,
                             plane.pw * plane.rz};
    const float step_y[3] = {-plane.ph * plane.ux, -plane.ph * plane.uy,
                             -plane.ph * plane.uz};
    pixel_delta(ray, iv, step_x, dxd);
    pixel_delta(ray, iv, step_y, dyd);
  }

  const float h_base = p.f[kHBase], rs = p.f[kRs], r_floor = p.f[kRFloor];
  const float inv_rs = p.f[kInvRs], inv_r_floor = p.f[kInvRFloor];
  const float rs2 = p.f[kRs2], r_escape2 = p.f[kREscape2];
  const float max_affine = p.f[kMaxAffine], tan_t = p.f[kTanT];
  const float r_in2 = p.f[kRIn2], r_out2 = p.f[kROut2];
  const int max_iter = p.i[kMaxIter];

  float slot[kSlots][5];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
#pragma unroll
    for (int f = 0; f < 5; ++f) slot[k][f] = 0.0f;
  }
  int count = 0;
  int n_steps = 0;
  bool is_captured = false, is_escaped = false;
  float ex = 0.0f, ey = 0.0f, ez = 0.0f;
  float affine = 0.0f;

  for (int it = 0; it < max_iter; ++it) {
    if constexpr (kSteps) ++n_steps;
    // r-adaptive step: h_base * clamp(min(sqrt(r/rs), 10) /
    // (1 + 2 (rs/r)^3), 0.2, 10), r clamped at rs + 1e-3; rs/r as
    // rs * min(rsqrt(r^2), 1/(rs + 1e-3)) with stage 1's rsqrt
    // (geodesic_pallas.py:284-294).
    const Stage s1(px, py, pz, neg15_l2);
    const float r = __fsqrt_rn(px * px + py * py + pz * pz);
    const float r_safe = fmaxf(r, r_floor);
    const float far = fminf(__fsqrt_rn(r_safe * inv_rs), F32(10.0));
    const float q = rs * fminf(s1.ir, inv_r_floor);
    const float near = __frcp_rn(F32(1.0) + F32(2.0) * (q * q * q));
    const float h = h_base * fminf(fmaxf(far * near, F32(0.2)), F32(10.0));

    // RK4 of (pos, dir) with a = -1.5 L^2 pos / r^5.
    const float k1px = h * vx, k1py = h * vy, k1pz = h * vz;
    const float k1dx = h * (s1.f * px), k1dy = h * (s1.f * py),
                k1dz = h * (s1.f * pz);
    const float k2px = h * (vx + F32(0.5) * k1dx);
    const float k2py = h * (vy + F32(0.5) * k1dy);
    const float k2pz = h * (vz + F32(0.5) * k1dz);
    const Stage s2(px + F32(0.5) * k1px, py + F32(0.5) * k1py,
                   pz + F32(0.5) * k1pz, neg15_l2);
    const float k2dx = h * (s2.f * s2.x), k2dy = h * (s2.f * s2.y),
                k2dz = h * (s2.f * s2.z);
    const float k3px = h * (vx + F32(0.5) * k2dx);
    const float k3py = h * (vy + F32(0.5) * k2dy);
    const float k3pz = h * (vz + F32(0.5) * k2dz);
    const Stage s3(px + F32(0.5) * k2px, py + F32(0.5) * k2py,
                   pz + F32(0.5) * k2pz, neg15_l2);
    const float k3dx = h * (s3.f * s3.x), k3dy = h * (s3.f * s3.y),
                k3dz = h * (s3.f * s3.z);
    const float k4px = h * (vx + k3dx), k4py = h * (vy + k3dy),
                k4pz = h * (vz + k3dz);
    const Stage s4(px + k3px, py + k3py, pz + k3pz, neg15_l2);
    const float k4dx = h * (s4.f * s4.x), k4dy = h * (s4.f * s4.y),
                k4dz = h * (s4.f * s4.z);

    const float sixth = F32(1.0 / 6.0), two = F32(2.0);
    const float npx = px + (k1px + two * k2px + two * k3px + k4px) * sixth;
    const float npy = py + (k1py + two * k2py + two * k3py + k4py) * sixth;
    const float npz = pz + (k1pz + two * k2pz + two * k3pz + k4pz) * sixth;
    const float nvx = vx + (k1dx + two * k2dx + two * k3dx + k4dx) * sixth;
    const float nvy = vy + (k1dy + two * k2dy + two * k3dy + k4dy) * sixth;
    const float nvz = vz + (k1dz + two * k2dz + two * k3dz + k4dz) * sixth;

    // r^2-space termination tests.
    const float nr2 = npx * npx + npy * npy + npz * npz;
    const float affine_new = affine + h;
    if (nr2 < rs2) {
      is_captured = true;
      break;
    }
    if (nr2 > r_escape2 || affine_new > max_affine) {
      is_escaped = true;
      ex = nvx; ey = nvy; ez = nvz;
      normalize3(ex, ey, ez);
      break;
    }

    // Differential transport on the surviving step (on a terminating
    // step its result would be discarded).
    float ndxp[3], ndxd[3], ndyp[3], ndyd[3];
    if constexpr (kDiff) {
      const Stage st[4] = {s1, s2, s3, s4};
      diff_rk4(h, st, dxp, dxd, ndxp, ndxd);
      diff_rk4(h, st, dyp, dyd, ndyp, ndyd);
    }

    // Crossing of the tilted plane z = y tan(tilt) on the surviving
    // segment, lerped within the step; recorded inside the annulus.
    if constexpr (kRecord) {
      const float f_old = pz - py * tan_t;
      const float f_new = npz - npy * tan_t;
      if (f_old * f_new < 0.0f) {
        const float t_frac = f_old * __frcp_rn(f_old - f_new + F32(1e-8));
        const float hx = px + t_frac * (npx - px);
        const float hy = py + t_frac * (npy - py);
        const float hr2 = hx * hx + hy * hy;
        if (hr2 >= r_in2 && hr2 <= r_out2 && count < kSlots) {
          if constexpr (kDiff) {
            // Slot `count` is written once, straight to global memory;
            // the differentials are lerped within the step (PARITY.md
            // deviation 3).
            float* out = hits + static_cast<int64_t>(count) * kFeatures * n_rays + n;
            out[0] = hx;
            out[n_rays] = hy;
            out[2 * n_rays] = vx;  // pre-step direction
            out[3 * n_rays] = vy;
            out[4 * n_rays] = vz;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              out[(5 + c) * n_rays] = dxp[c] + t_frac * (ndxp[c] - dxp[c]);
              out[(8 + c) * n_rays] = dyp[c] + t_frac * (ndyp[c] - dyp[c]);
            }
            out[11 * n_rays] = t_frac;
          } else {
#pragma unroll
            for (int k = 0; k < kSlots; ++k) {
              if (k == count) {
                slot[k][0] = hx;
                slot[k][1] = hy;
                slot[k][2] = vx;  // pre-step direction
                slot[k][3] = vy;
                slot[k][4] = vz;
              }
            }
          }
          ++count;
        }
      }
    }

    px = npx; py = npy; pz = npz;
    vx = nvx; vy = nvy; vz = nvz;
    affine = affine_new;
    if constexpr (kDiff) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dxp[c] = ndxp[c]; dxd[c] = ndxd[c];
        dyp[c] = ndyp[c]; dyd[c] = ndyd[c];
      }
    }
  }

  captured[n] = is_captured ? 1 : 0;
  escaped[n] = is_escaped ? 1 : 0;
  escape_dir[3 * n + 0] = ex;
  escape_dir[3 * n + 1] = ey;
  escape_dir[3 * n + 2] = ez;
  hit_count[n] = count;
  if constexpr (kSteps) steps[n] = n_steps;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    float* out = hits + static_cast<int64_t>(k) * kFeatures * n_rays + n;
    if constexpr (kDiff) {
      if (k >= count) {
#pragma unroll
        for (int f = 0; f < kFeatures; ++f) out[f * n_rays] = 0.0f;
      }
    } else {
#pragma unroll
      for (int f = 0; f < 5; ++f) out[f * n_rays] = slot[k][f];
#pragma unroll
      for (int f = 5; f < kFeatures; ++f) out[f * n_rays] = 0.0f;
    }
  }
}

// Launch one instantiation on `stream`; returns the cudaError_t of the
// launch and does not synchronize.
template <bool kDiff, bool kRecord, bool kSteps>
int launch(const float* fparams, const int* iparams, const float* cam,
           void* captured, void* escaped, void* escape_dir, void* hit_count,
           void* hits, void* steps, void* stream) {
  Params p;
  for (int j = 0; j < kNumFParams; ++j) p.f[j] = fparams[j];
  for (int j = 0; j < kNumIParams; ++j) p.i[j] = iparams[j];
  if (p.i[kWidth] <= 0 || p.i[kRows] <= 0 || p.i[kRow0] < 0 ||
      p.i[kRow0] + p.i[kRows] > p.i[kHeight])
    return cudaErrorInvalidValue;
  if (kSteps && steps == nullptr) return cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((p.i[kWidth] + kBlockX - 1) / kBlockX,
                  (p.i[kRows] + kBlockY - 1) / kBlockY);
  ray_march<kDiff, kRecord, kSteps>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          p, cam, static_cast<uint8_t*>(captured),
          static_cast<uint8_t*>(escaped), static_cast<float*>(escape_dir),
          static_cast<int32_t*>(hit_count), static_cast<float*>(hits),
          static_cast<int32_t*>(steps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes), one per instantiation the
// wrapper uses (geodesic_cuda.KERNELS). `steps` is ignored by the
// variants without step counts and may be NULL there.
#define BHR_RAY_MARCH_ENTRY(name, kDiff, kRecord, kSteps)                    \
  extern "C" int name(const float* fparams, const int* iparams,              \
                      const float* cam, void* captured, void* escaped,       \
                      void* escape_dir, void* hit_count, void* hits,         \
                      void* steps, void* stream) {                           \
    return launch<kDiff, kRecord, kSteps>(fparams, iparams, cam, captured,   \
                                          escaped, escape_dir, hit_count,    \
                                          hits, steps, stream);              \
  }

BHR_RAY_MARCH_ENTRY(bhr_ray_march_slim, false, true, false)
BHR_RAY_MARCH_ENTRY(bhr_ray_march_aa, true, true, false)
BHR_RAY_MARCH_ENTRY(bhr_ray_march_nodisk, false, false, false)
BHR_RAY_MARCH_ENTRY(bhr_ray_march_slim_steps, false, true, true)
BHR_RAY_MARCH_ENTRY(bhr_ray_march_aa_steps, true, true, true)
BHR_RAY_MARCH_ENTRY(bhr_ray_march_nodisk_steps, false, false, true)

// Constants the wrapper checks against its own, so the two layouts
// cannot drift apart silently.
extern "C" int bhr_ray_march_layout(int which) {
  switch (which) {
    case 0: return kNumFParams;
    case 1: return kNumIParams;
    case 2: return kSlots;
    case 3: return kFeatures;
    case 4: return kNumVariants;
    default: return -1;
  }
}
