// Train-mode BatchNorm's forward for Hopper (sm_90a), as two kernels:
//   bn_stats: per-channel sums of x and x^2 in f32 over the rows a batch
//             mask keeps, and their element count (or, with `means`, the
//             sums divided by it: E[x] and E[x^2]);
//   bn_apply: y = ((x - mean) * mul + bias) rounded to the activation's
//             type, mul = rsqrt(var + eps) * scale, var = E[x^2] - E[x]^2
//             clipped at 0 (or the running variance in eval mode), with an
//             optional residual add and ReLU as its epilogue.
//
// Replaces no TPU kernel: the JAX package's flax BatchNorm was XLA's. The
// PyTorch version it replaces is flax's arithmetic written as ~20 plain
// operations a layer (models/resnet.py, `batch_norm`), plus the ReLU and
// the residual add that follow it; the plain twins of both kernels are in
// multimodal_auv_torch/ops/batchnorm.py, which launches these.
//
// Numerics. The kernels round where the plain operations round: x is read
// in its own type and widened to f32 (exact); the statistics are sums in
// f32 (only their order differs from the plain reduction's); per element
// (x - mean), then * mul, then + bias, each rounded in f32 (built with
// --fmad=false, so nothing is contracted), then rounded to the activation
// type; with a residual, that value plus the identity in f32, rounded
// again (what PyTorch's bf16 add does); then ReLU. mul is rsqrtf(var + eps)
// * scale, as torch.rsqrt computes it, and var keeps a NaN as clamp_min
// does. The division by the count is a true division when a mask gave
// the count, and a multiplication by its f32 reciprocal when the count is
// the batch's (what PyTorch's CUDA division by a Python number does).
//
// Layout. The trunks permute NHWC inputs to NCHW views, so cuDNN hands
// BatchNorm channels-last tensors: memory rows of C channels, M = N H W
// rows. The kernels take that layout alone; the wrapper converts a
// contiguous NCHW tensor to it (and the output back), and refuses any
// other layout.
//
// Determinism. No float atomics: each block writes its partial sums, the
// last block of a channel tile to finish (an integer ticket per tile, in a
// buffer the wrapper keeps per stream and that every last block sets back
// to 0) adds the partials in block order. The geometry is a function of
// the shape alone (ops/batchnorm.py), so the same input gives the same
// bits.
//
// What bounds them on an H100. Bytes: bn_stats reads x once (2 bytes an
// element in bf16) and writes partials of 8 C bytes a block; bn_apply
// reads x (and the identity) and writes y once. At 3.35 TB/s a ResNet-50
// trunk at b128, 256 px holds 1.86e9 BN elements: 1.1 ms of statistics
// and 2.2 ms of apply, 0.6 ms more for the residual reads; measured on an
// H100 80GB HBM3 at 700 W, 2.36 and 3.14 ms (2.1x and 1.13x: the
// statistics' smallest layers, 2.5-8 MB, take a few serial load rounds
// and the last block's sum, 3-6x their bound). Design: a thread loads 16
// bytes (8 bf16 or 4 f32 of consecutive channels) and keeps one set of
// channels for its whole life, so its per-channel constants stay in
// registers; a block covers `tx` channel
// vectors (a divisor of C / V, at most 32: a warp reads 512 contiguous
// bytes) by 256 / tx rows (512 / tx in the statistics), and the grid is
// about one wave of resident blocks (four of 256 threads an SM, two of
// 512). The last block's sums keep sixteen loads in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the rows statistics kernel's blocks: two an SM, so that a layer has half
// as many partial sums to add as with four of 256
constexpr int kStatsThreads = 512;
constexpr int kUnroll = 4;  // rows a statistics thread loads before adding

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

// The mean, the per-channel multiplier and the bias of channel c, rounded
// where the plain version rounds them.
__device__ __forceinline__ void channel_consts(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float eps, int second_is_var, int c, float& mean, float& mul,
    float& shift) {
  mean = a[c];
  float var = b[c];
  if (!second_is_var) {
    var = var - mean * mean;
    var = var < 0.f ? 0.f : var;  // clamp_min(., 0): a NaN stays NaN
  }
  mul = rsqrtf(var + eps) * scale[c];
  shift = bias[c];
}

// One output element: the normalised value rounded to T, then the
// residual add (rounded again) and the ReLU.
template <typename T>
__device__ __forceinline__ T bn_out(T x, float mean, float mul, float shift,
                                    bool has_res, T r, int relu) {
  const float d = to_f(x) - mean;
  const float z = d * mul;
  T t = from_f<T>(z + shift);
  if (has_res) t = from_f<T>(to_f(t) + to_f(r));
  if (relu) {
    const float f = to_f(t);
    if (!(f != f)) t = from_f<T>(fmaxf(f, 0.f));  // torch.relu keeps NaN
  }
  return t;
}

// The count the statistics divide by: kept rows times H W, in f32 as the
// plain version forms it. Called by every thread of a block.
__device__ float kept_count(const unsigned char* __restrict__ mask, int N,
                            int HW) {
  if (mask == nullptr) return (float)((long long)N * HW);
  int kept = 0;
  for (int n0 = 0; n0 < N; n0 += blockDim.x) {
    const int n = n0 + (int)threadIdx.x;
    kept += __syncthreads_count(n < N && mask[n] != 0);
  }
  return (float)kept * (float)HW;
}

// Whether this block is the last of the `G` blocks of ticket `t` to have
// written its partials (every thread calls it; the partials are written).
__device__ bool last_block(unsigned int* tickets, int t, int G) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&tickets[t], 1u) == (unsigned)G - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Partials g0 <= g < g1 of one column (`stride` apart), added as kLanes
// interleaved sums (kLanes loads in flight: the last block's reads of the
// partials are L2 round trips) and then in a fixed tree.
constexpr int kLanes = 16;

__device__ __forceinline__ float column_sum(const float* __restrict__ p,
                                            int g0, int g1, size_t stride) {
  float a[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) a[j] = 0.f;
  int g = g0;
  for (; g + kLanes <= g1; g += kLanes) {
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
      a[j] += __ldcg(p + (size_t)(g + j) * stride);
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j)
    if (g + j < g1) a[j] += __ldcg(p + (size_t)(g + j) * stride);
#pragma unroll
  for (int w = kLanes / 2; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) a[j] += a[j + w];
  return a[0];
}

// The last block of a tile: output o in [0, 2 cw) is column
// (o < cw ? 0 : C) + base + o % cw of the (G, 2C) partials, summed over the
// G blocks (split over up to blockDim / (2 cw) threads by ranges of blocks,
// the ranges then added in order), then divided by the count with
// `means`. `sh` holds at least blockDim floats.
__device__ void finalize(const float* __restrict__ part, int G, int C,
                         int cw, int base, float* __restrict__ out,
                         float* sh, const unsigned char* __restrict__ mask,
                         int N, int HW, int means, bool write_count) {
  const float count = kept_count(mask, N, HW);
  const float inv = 1.0f / count;
  const int nt = blockDim.x;
  const int nout = 2 * cw;
  const int per = nout >= nt ? 1 : nt / nout;
  const size_t stride = 2 * (size_t)C;
  auto col = [&](int o) {
    return (o < cw ? 0 : C) + base + (o < cw ? o : o - cw);
  };
  auto result = [&](float acc) {
    if (!means) return acc;
    return mask != nullptr ? acc / count : acc * inv;
  };
  if (per == 1) {
    for (int o = threadIdx.x; o < nout; o += nt) {
      const int c = col(o);
      out[c] = result(column_sum(part + c, 0, G, stride));
    }
  } else {
    const int o = threadIdx.x % nout, i = threadIdx.x / nout;
    if (i < per) {
      const int g0 = (int)((long long)G * i / per);
      const int g1 = (int)((long long)G * (i + 1) / per);
      sh[i * nout + o] = column_sum(part + col(o), g0, g1, stride);
    }
    __syncthreads();
    if ((int)threadIdx.x < nout) {
      float acc = 0.f;
      for (int j = 0; j < per; ++j) acc += sh[j * nout + threadIdx.x];
      out[col(threadIdx.x)] = result(acc);
    }
  }
  if (write_count && threadIdx.x == 0) out[2 * C] = count;
}

// Statistics over rows of C channels. Block (g, tile): channels [tile cw,
// (tile + 1) cw), cw = tx V; thread (tx, ty) adds rows g ty_n + ty, then
// every G ty_n rows on (ty_n = 512 / tx), at its V channels.
template <typename T, int V>
__global__ void __launch_bounds__(kStatsThreads, 2) bn_stats_rows_kernel(
    const T* __restrict__ x, const unsigned char* __restrict__ mask,
    float* __restrict__ out, float* __restrict__ part,
    unsigned int* __restrict__ tickets, int N, int C, int HW, int tx_n,
    int means) {
  __shared__ float red[2 * kStatsThreads * V];
  const int ty_n = kStatsThreads / tx_n;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  const int G = gridDim.x;
  const int cw = tx_n * V;
  const int c0 = blockIdx.y * cw + tx * V;
  // rows below 2^31 (the wrapper refuses more): 32-bit row arithmetic
  const unsigned M = (unsigned)N * (unsigned)HW;
  const unsigned step = (unsigned)G * ty_n;
  // a row's image: a shift where H W is a power of two (every ResNet layer)
  const bool pow2 = (HW & (HW - 1)) == 0;
  const int shift = __ffs(HW) - 1;
  float s[V], q[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = q[v] = 0.f;
  if (ty < ty_n) {
    // grid-stride: at any time the blocks read neighbouring rows (with a
    // contiguous range of rows a block, the largest layer ran at 39% of
    // its bytes' bound on the H100; grid-stride, at 61-64%)
    for (unsigned r = blockIdx.x * ty_n + ty; r < M; r += kUnroll * step) {
      Vec<T, V> a[kUnroll];
      bool keep[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned ru = r + u * step;
        keep[u] = ru < M && (mask == nullptr ||
                             mask[pow2 ? ru >> shift : ru / HW] != 0);
        if (keep[u]) a[u] = load<T, V>(x + (size_t)ru * C + c0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!keep[u]) continue;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float f = to_f(a[u].v[v]);
          s[v] += f;
          q[v] += f * f;
        }
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red[ty * cw + tx * V + v] = s[v];
      red[kStatsThreads * V + ty * cw + tx * V + v] = q[v];
    }
  }
  __syncthreads();
  // this block's partials: each channel's rows added in ty order
  for (int o = threadIdx.x; o < 2 * cw; o += kStatsThreads) {
    const float* src = red + (o < cw ? 0 : kStatsThreads * V);
    const int j = o < cw ? o : o - cw;
    float acc = 0.f;
    for (int t = 0; t < ty_n; ++t) acc += src[t * cw + j];
    part[blockIdx.x * 2 * (size_t)C + (o < cw ? 0 : C) + blockIdx.y * cw +
         j] = acc;
  }
  if (!last_block(tickets, blockIdx.y, G)) return;
  __syncthreads();  // red is reused below
  finalize(part, G, C, cw, blockIdx.y * cw, out, red, mask, N, HW, means,
           blockIdx.y == 0);
  if (threadIdx.x == 0) tickets[blockIdx.y] = 0;
}

// Apply over rows of C channels: block (g, tile) as in the statistics; a
// thread computes its V channels' constants once and strides over rows.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) bn_apply_rows_kernel(
    const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float eps, int second_is_var, int relu, long long M, int C, int tx_n) {
  const int ty_n = kThreads / tx_n;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  if (ty >= ty_n) return;
  const int c0 = (blockIdx.y * tx_n + tx) * V;
  float mean[V], mul[V], shift[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    channel_consts(a, b, scale, bias, eps, second_is_var, c0 + v, mean[v],
                   mul[v], shift[v]);
  const bool has_res = res != nullptr;
  const long long step = (long long)gridDim.x * ty_n;
  long long r = (long long)blockIdx.x * ty_n + ty;
  for (; r + step < M; r += 2 * step) {
    const size_t o0 = (size_t)r * C + c0, o1 = o0 + (size_t)step * C;
    const Vec<T, V> x0 = load<T, V>(x + o0), x1 = load<T, V>(x + o1);
    Vec<T, V> r0{}, r1{}, y0, y1;
    if (has_res) {
      r0 = load<T, V>(res + o0);
      r1 = load<T, V>(res + o1);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      y0.v[v] = bn_out(x0.v[v], mean[v], mul[v], shift[v], has_res, r0.v[v],
                       relu);
      y1.v[v] = bn_out(x1.v[v], mean[v], mul[v], shift[v], has_res, r1.v[v],
                       relu);
    }
    *reinterpret_cast<Vec<T, V>*>(y + o0) = y0;
    *reinterpret_cast<Vec<T, V>*>(y + o1) = y1;
  }
  if (r < M) {
    const size_t o0 = (size_t)r * C + c0;
    const Vec<T, V> x0 = load<T, V>(x + o0);
    Vec<T, V> r0{}, y0;
    if (has_res) r0 = load<T, V>(res + o0);
#pragma unroll
    for (int v = 0; v < V; ++v)
      y0.v[v] = bn_out(x0.v[v], mean[v], mul[v], shift[v], has_res, r0.v[v],
                       relu);
    *reinterpret_cast<Vec<T, V>*>(y + o0) = y0;
  }
}

template <typename T, int V>
void stats(const void* x, const unsigned char* mask, float* out, float* part,
           unsigned int* tickets, int N, int C, int HW, int tx, int grid,
           int means, cudaStream_t s) {
  bn_stats_rows_kernel<T, V><<<dim3(grid, C / V / tx), kStatsThreads, 0, s>>>(
      static_cast<const T*>(x), mask, out, part, tickets, N, C, HW, tx,
      means);
}

template <typename T, int V>
void apply(const void* x, const void* res, void* y, const float* a,
           const float* b, const float* scale, const float* bias, float eps,
           int second_is_var, int relu, int N, int C, int HW, int tx,
           int grid, cudaStream_t s) {
  bn_apply_rows_kernel<T, V><<<dim3(grid, C / V / tx), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<T*>(y), a, b, scale, bias, eps, second_is_var, relu,
      (long long)N * HW, C, tx);
}

// Whether the geometry fits the kernels: V is 1 or 16 bytes of T and
// divides the row; tx divides C / V.
bool geometry_ok(int N, int C, int HW, int bf16, int vec, int tx, int grid) {
  const int wide = bf16 ? 8 : 4;
  if (N < 0 || C < 1 || HW < 1 || grid < 1 || grid > 65535) return false;
  if (vec != 1 && vec != wide) return false;
  return C % vec == 0 && tx >= 1 && tx <= 32 && (C / vec) % tx == 0 &&
         C / vec / tx <= 65535;
}

}  // namespace

// Statistics of x (N, C, H, W, channels-last; bf16 if `bf16` else f32)
// into out (2C + 1 f32): sums of x and x^2 per channel over the rows mask
// (N bytes, or null: every row) keeps, then the element count; with
// `means` the sums divided by the count. part: grid x 2C f32 of scratch;
// tickets: at least C / vec / tx zeroed unsigned ints that only launches on
// this stream use, left zeroed. vec, tx and grid: the geometry
// (ops/batchnorm.py). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a geometry it does not take.
extern "C" int bn_stats_launch(const void* x, const unsigned char* mask,
                               float* out, float* part,
                               unsigned int* tickets, int N, int C, int HW,
                               int bf16, int vec, int tx, int grid, int means,
                               void* stream) {
  if (!geometry_ok(N, C, HW, bf16, vec, tx, grid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && vec == 8)
    stats<__nv_bfloat16, 8>(x, mask, out, part, tickets, N, C, HW, tx, grid,
                            means, s);
  else if (bf16)
    stats<__nv_bfloat16, 1>(x, mask, out, part, tickets, N, C, HW, tx, grid,
                            means, s);
  else if (vec == 4)
    stats<float, 4>(x, mask, out, part, tickets, N, C, HW, tx, grid, means,
                    s);
  else
    stats<float, 1>(x, mask, out, part, tickets, N, C, HW, tx, grid, means,
                    s);
  return (int)cudaGetLastError();
}

// y = BatchNorm(x) in x's type (channels-last), from mean (a) and E[x^2]
// (b; the variance itself with second_is_var), scale and bias (C f32
// each), then + res (x's shape, type and layout, or null) and ReLU if
// `relu`. Same geometry and return convention as bn_stats_launch.
extern "C" int bn_apply_launch(const void* x, const void* res, void* y,
                               const float* a, const float* b,
                               const float* scale, const float* bias,
                               float eps, int second_is_var, int relu, int N,
                               int C, int HW, int bf16, int vec, int tx,
                               int grid, void* stream) {
  if (!geometry_ok(N, C, HW, bf16, vec, tx, grid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16 && vec == 8)
    apply<__nv_bfloat16, 8>(x, res, y, a, b, scale, bias, eps, second_is_var,
                            relu, N, C, HW, tx, grid, s);
  else if (bf16)
    apply<__nv_bfloat16, 1>(x, res, y, a, b, scale, bias, eps, second_is_var,
                            relu, N, C, HW, tx, grid, s);
  else if (vec == 4)
    apply<float, 4>(x, res, y, a, b, scale, bias, eps, second_is_var, relu, N,
                    C, HW, tx, grid, s);
  else
    apply<float, 1>(x, res, y, a, b, scale, bias, eps, second_is_var, relu, N,
                    C, HW, tx, grid, s);
  return (int)cudaGetLastError();
}
