// Bloom and the composite clamp of the post layer for NVIDIA Hopper
// (sm_90a): ops/bloom.py's bright pass, its separable per-channel blur
// and pipeline.post_process's clamp((bg + disk) + blur, 0, 1), in two
// launches.
//
// Replaces no Pallas kernel. bhr_tpu leaves bloom to XLA
// (bhr_tpu/ops/bloom.py: apply_bloom with banded matrices, and
// apply_bloom_conv), which fuses it under jit on the TPU. Run eagerly by
// PyTorch, the blur is one shifted multiply-add a tap, and each tap is
// three launches (the product, the numerator's add, the denominator's
// add) that read and write the whole image: with radius R = int(0.02 *
// W), 2 axes x (2R + 1) taps x 3 = 462 launches a frame at FHD (R 38)
// and 918 at 4K (R 76), ~19 GB of traffic a frame at FHD and ~150 GB at
// 4K. This kernel is the blur and the composite as two launches; its
// plain version, in the same module, is bloom_composite_plain, and the
// wrapper sends a CPU tensor there and a CUDA tensor here, with no
// fallback.
//
// What bounds it on this card: operations. The blur is 2 passes x
// (2R + 1) taps x (one multiply + one add) over H x W x 3 values: 1.92 G
// FP32 operations at FHD and 15.3 G at 4K, ~0.06 ms and ~0.46 ms at one
// operation a lane and a clock on 132 SMs x 128 lanes x 1.98 GHz: no
// product may fuse into an FMA if the plain rounding is to be kept. The
// bytes of the two passes (the disk layer in, the intermediate out and
// in, bg and disk in, the frame out) are ~125 MB at FHD (0.04 ms at
// 3.35 TB/s) and ~500 MB at 4K (0.15 ms).
//
// Design:
//  * Horizontal launch (bloom_rows): a block of three warps, one a
//    channel, takes a segment of kSeg pixels of one row plus its 2R
//    halo. It computes the bright pass as it loads the segment into
//    shared memory as three planes (sources outside the row are 0), then
//    each thread blurs kTx neighbouring pixels of its channel, and the
//    block writes num / den through shared memory as coalesced rows of
//    the float32 (H, W, 3) intermediate.
//  * Vertical launch (bloom_cols): a block takes a strip of 32 floats of
//    the interleaved rows (coalesced along W) and kRun rows plus their
//    2R halo in shared memory; each thread blurs kTy neighbouring rows of
//    one float column. Its epilogue adds the blur to bg + disk, clamps,
//    and writes the float32 frame.
//  * Register blocking: a thread keeps T outputs' sums and slides a
//    window of T + kUnroll - 1 sources over kUnroll taps at a time, so a
//    shared-memory load feeds up to T products. The strides are odd or
//    unit across a warp, so the loads are free of bank conflicts.
//  * Bit-equal to the plain version on the card. The taps and the
//    per-position denominators are the plain version's float32 values
//    (the wrapper passes them, computed once per frame size). Each
//    output sums its taps in ascending k from 0.0f with __fmul_rn /
//    __fadd_rn (nvcc's -fmad=true, kept for the ray march, would
//    otherwise fuse them), and divides with __fdiv_rn. A source outside
//    the axis, which the plain version skips, is 0 here: its product
//    w * 0 is +0, and a sum begun at +0.0f is never -0.0, so adding +0
//    leaves it unchanged, also at NaN and infinity. The bright pass
//    rounds lum = ((d0 * 0.2126) + (d1 * 0.7152)) + (d2 * 0.0722) as
//    torch's eager kernels do (each Python scalar rounded to float), and
//    the clamp is torch's (NaN passes through).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;          // taps a window slides over
constexpr int kTx = 9;              // outputs a thread along a row (odd stride)
constexpr int kSeg = 32 * kTx;      // pixels a row block: 288
constexpr int kRowThreads = 96;     // a warp a channel
constexpr int kTy = 8;              // outputs a thread down a column
constexpr int kNy = 8;              // threads down a column block
constexpr int kRun = kTy * kNy;     // rows a column block: 64
constexpr int kStrip = 32;          // floats across a column block: a warp
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block on sm_90

#define F32(x) static_cast<float>(x)

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// torch.clamp on CUDA: NaN passes through.
__device__ __forceinline__ float clamp01(float v) {
  return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// acc[t] = sum over k ascending of src[(t + k) * S] * w[k], k < K: the
// plain version's tap loop for T neighbouring outputs, whose sources lie
// S floats apart in shared memory.
template <int T, int S>
__device__ __forceinline__ void blur_taps(const float* __restrict__ src,
                                          const float* __restrict__ w, int K,
                                          float (&acc)[T]) {
#pragma unroll
  for (int t = 0; t < T; ++t) acc[t] = 0.0f;
  int k = 0;
  for (; k + kUnroll <= K; k += kUnroll) {
    float win[T + kUnroll - 1];
#pragma unroll
    for (int i = 0; i < T + kUnroll - 1; ++i) win[i] = src[(k + i) * S];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float wk = w[k + u];
#pragma unroll
      for (int t = 0; t < T; ++t) acc[t] = add(acc[t], mul(win[t + u], wk));
    }
  }
  for (; k < K; ++k) {
    const float wk = w[k];
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = add(acc[t], mul(src[(k + t) * S], wk));
  }
}

// Shared memory: 3 planes of kSeg + 2R sources, then the 3 x K taps.
__global__ void __launch_bounds__(kRowThreads)
bloom_rows(const float* __restrict__ disk, const float* __restrict__ taps,
           const float* __restrict__ den_x, float* __restrict__ tmp, int width,
           int radius) {
  extern __shared__ float sm[];
  const int K = 2 * radius + 1, span = kSeg + 2 * radius;
  float* plane = sm;
  float* w = sm + 3 * span;
  const int y = blockIdx.y, x0 = blockIdx.x * kSeg;
  const float* row = disk + static_cast<int64_t>(y) * width * 3;
  for (int i = threadIdx.x; i < 3 * K; i += kRowThreads) w[i] = taps[i];
  for (int i = threadIdx.x; i < span; i += kRowThreads) {
    const int x = x0 - radius + i;
    float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
    if (x >= 0 && x < width) {
      d0 = row[3 * x];
      d1 = row[3 * x + 1];
      d2 = row[3 * x + 2];
      // where(lum > 0, d, 0): NaN in lum keeps nothing.
      const float lum = add(add(mul(d0, F32(0.2126)), mul(d1, F32(0.7152))),
                            mul(d2, F32(0.0722)));
      if (!(lum > 0.0f)) d0 = d1 = d2 = 0.0f;
    }
    plane[i] = d0;
    plane[span + i] = d1;
    plane[2 * span + i] = d2;
  }
  __syncthreads();

  const int c = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[kTx];
  blur_taps<kTx, 1>(plane + c * span + lane * kTx, w + c * K, K, acc);
  __syncthreads();  // the planes become the output stage

  float* stage = sm;  // kSeg x 3, interleaved as the output
#pragma unroll
  for (int t = 0; t < kTx; ++t) {
    const int x = x0 + lane * kTx + t;
    stage[(lane * kTx + t) * 3 + c] = x < width ? __fdiv_rn(acc[t], den_x[3 * x + c]) : 0.0f;
  }
  __syncthreads();
  const int n = 3 * min(kSeg, width - x0);
  float* dst = tmp + (static_cast<int64_t>(y) * width + x0) * 3;
  for (int i = threadIdx.x; i < n; i += kRowThreads) dst[i] = stage[i];
}

// Shared memory: kRun + 2R rows of kStrip sources, then the 3 x K taps.
__global__ void __launch_bounds__(kStrip * kNy)
bloom_cols(const float* __restrict__ tmp, const float* __restrict__ bg,
           const float* __restrict__ disk, const float* __restrict__ taps,
           const float* __restrict__ den_y, float* __restrict__ out, int height,
           int width, int radius) {
  extern __shared__ float sm[];
  const int K = 2 * radius + 1, rows = kRun + 2 * radius, pitch = 3 * width;
  float* col = sm;
  float* w = sm + rows * kStrip;
  const int lane = threadIdx.x, ty = threadIdx.y, tid = ty * kStrip + lane;
  const int j = blockIdx.x * kStrip + lane;  // float column of the rows
  const int y0 = blockIdx.y * kRun;
  for (int i = tid; i < 3 * K; i += kStrip * kNy) w[i] = taps[i];
  for (int r = ty; r < rows; r += kNy) {
    const int y = y0 - radius + r;
    col[r * kStrip + lane] =
        (j < pitch && y >= 0 && y < height) ? tmp[static_cast<int64_t>(y) * pitch + j] : 0.0f;
  }
  __syncthreads();
  if (j >= pitch) return;

  const int c = j % 3;
  float acc[kTy];
  blur_taps<kTy, kStrip>(col + ty * kTy * kStrip + lane, w + c * K, K, acc);
#pragma unroll
  for (int t = 0; t < kTy; ++t) {
    const int y = y0 + ty * kTy + t;
    if (y < height) {
      const int64_t idx = static_cast<int64_t>(y) * pitch + j;
      const float blur = __fdiv_rn(acc[t], den_y[3 * y + c]);
      out[idx] = clamp01(add(add(bg[idx], disk[idx]), blur));
    }
  }
}

size_t rows_shared_bytes(int radius) {
  return sizeof(float) * (3 * (kSeg + 2 * radius) + 3 * (2 * radius + 1));
}

size_t cols_shared_bytes(int radius) {
  return sizeof(float) * ((kRun + 2 * radius) * kStrip + 3 * (2 * radius + 1));
}

// Opt a kernel in to more than 48 KB of dynamic shared memory (R above ~150).
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// out = clamp((bg + disk) + bloom(disk), 0, 1) over (height, width, 3)
// float32 layers, in two launches on `stream`: `tmp` (height x width x 3)
// takes the horizontal blur; `taps` is the plain version's (3, 2R + 1)
// float32 taps, `den_x` and `den_y` its clamped denominators, (width, 3)
// and (height, 3). Returns the first non-zero cudaError_t of the
// launches and does not synchronize.
extern "C" int bhr_bloom(const void* bg, const void* disk, const void* taps,
                         const void* den_x, const void* den_y, void* tmp, void* out,
                         int height, int width, int radius, void* stream) {
  if (height < 1 || height > 65535 || width < 1 || radius < 1 ||
      static_cast<int64_t>(height) * width * 3 > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  const size_t rows_bytes = rows_shared_bytes(radius), cols_bytes = cols_shared_bytes(radius);
  if (rows_bytes > kMaxSharedBytes || cols_bytes > kMaxSharedBytes)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_shared(bloom_rows, rows_bytes);
  if (err == cudaSuccess) err = allow_shared(bloom_cols, cols_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);

  const dim3 rows_grid((width + kSeg - 1) / kSeg, height);
  bloom_rows<<<rows_grid, kRowThreads, rows_bytes, s>>>(
      static_cast<const float*>(disk), static_cast<const float*>(taps),
      static_cast<const float*>(den_x), static_cast<float*>(tmp), width, radius);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 cols_grid((3 * width + kStrip - 1) / kStrip, (height + kRun - 1) / kRun);
  bloom_cols<<<cols_grid, dim3(kStrip, kNy), cols_bytes, s>>>(
      static_cast<const float*>(tmp), static_cast<const float*>(bg),
      static_cast<const float*>(disk), static_cast<const float*>(taps),
      static_cast<const float*>(den_y), static_cast<float*>(out), height, width, radius);
  return static_cast<int>(cudaGetLastError());
}
