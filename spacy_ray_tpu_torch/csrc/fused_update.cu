// Fused Adam / RAdam optimizer update, in place, over every parameter leaf in
// one launch:
//
//   g  <- clip(g)  [+ l2_grad * p]
//   m' =  (1 - b1) * g + b1 * m          v' = (1 - b2) * g*g + b2 * v
//   u  =  m'/bc1 / (sqrt(v'/bc2) + eps)   (RAdam: rect * ... where ro >= 5)
//   p' =  p + step_size * (u [+ l2_decay * p])
//
// Replaces the TPU kernel spacy_ray_tpu/ops/fused_update.py::_update_kernel
// (launched once per leaf by _kernel_leaf). That kernel pads every leaf to
// whole (2048, 128) blocks and is launched per leaf; its expressions are
// _leaf_math's, which follow optax 0.2.3's chain so the result agrees with
// the reference to the last bit.
//
// Bound on the H100: bytes, 28 per parameter (p, g, m, v read; p, m, v
// written) against about 20 operations; the 131M parameters of the
// transformer + tagger pipeline move 3.67 GB per step.
//
// Design: the wrapper builds, once per parameter set, a device table of
// chunks (ops/fused_update.py: chunk_plan). A chunk is a run of one leaf:
// the addresses of its first element in p, g, m and v, its length, and
// whether it is a vector chunk. One CTA takes one chunk, so one launch walks
// every leaf with no padding and no per-leaf launch.
//
// - Vector chunks start 16 bytes aligned in all four tensors and hold a
//   multiple of 4 elements. Each thread loads float4s of p, g, m and v, kVec
//   of each (all 4 * kVec loads issued before any arithmetic), so that many
//   bytes are in flight on every SM.
// - A leaf's head before its first 16-byte boundary and its tail after its
//   last whole vector are scalar chunks of the same launch; so is a whole
//   leaf whose four tensors sit at different offsets from 16 bytes.
// - The branches (clipping, classic L2, decoupled decay, Adam / rectified
//   RAdam / unrectified RAdam) are template parameters, chosen on the host:
//   RAdam's ro >= threshold is a host comparison of two step scalars. Whether
//   clipping scales is one comparison per CTA of the gradient's global norm,
//   which stays on the device (a pointer, read once per CTA) so the host
//   never waits for it.
// - 256 threads a CTA, plain loads and stores: with the wrapper's chunk of
//   4096 elements each thread makes one pass of kVec float4s per tensor.
//   Evict-first hints on g and the stores measured no faster (PERF.md).
//
// The expression order is _leaf_math's, term for term. This source is
// compiled with --fmad=false so that no a*b + c becomes an FMA: the result
// is then bit-equal to the plain PyTorch version (separate elementwise ops,
// each rounded) and to the reference run op by op. Division and sqrt are the
// IEEE-rounded ones (nvcc's default without fast math). The coefficients
// (1 - b1), (1 - b2), eps and the L2 and clip constants arrive as the f32
// roundings of the Python doubles, as JAX's weak-typed constants are.
#include <array>
#include <utility>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;  // float4s of each tensor a thread holds per pass
constexpr int kChunkFields = 6;

enum Mode { kAdam = 0, kRadamRect = 1, kRadamPlain = 2 };

struct Coef {
  float b1c, b1, b2c, b2, eps, grad_clip, l2_grad, l2_decay, bc1, bc2, step_size, rect;
};

template <bool CLIP, bool L2, bool DECAY, int MODE>
__device__ __forceinline__ void update(float& p, float g, float& m, float& v, const Coef& c,
                                       bool scale, float gnorm) {
  if (CLIP && scale) g = (g / gnorm) * c.grad_clip;
  if (L2) g = g + c.l2_grad * p;
  const float m2 = c.b1c * g + c.b1 * m;
  const float v2 = c.b2c * (g * g) + c.b2 * v;
  const float mu_hat = m2 / c.bc1;
  float u = mu_hat;
  if (MODE == kAdam) u = mu_hat / (sqrtf(v2 / c.bc2) + c.eps);
  if (MODE == kRadamRect) u = c.rect * mu_hat / (sqrtf(v2 / c.bc2) + c.eps);
  if (DECAY) u = u + c.l2_decay * p;
  u = c.step_size * u;
  p = p + u;
  m = m2;
  v = v2;
}

template <bool CLIP, bool L2, bool DECAY, int MODE>
__global__ void __launch_bounds__(kThreads)
fused_update(const long long* __restrict__ chunks, const float* __restrict__ gnorm_p, Coef c) {
  const long long* ch = chunks + kChunkFields * static_cast<long long>(blockIdx.x);
  float* __restrict__ p = reinterpret_cast<float*>(ch[0]);
  const float* __restrict__ g = reinterpret_cast<const float*>(ch[1]);
  float* __restrict__ m = reinterpret_cast<float*>(ch[2]);
  float* __restrict__ v = reinterpret_cast<float*>(ch[3]);
  const int n = static_cast<int>(ch[4]);
  __shared__ float s_gnorm;
  if (CLIP) {
    if (threadIdx.x == 0) s_gnorm = *gnorm_p;
    __syncthreads();
  }
  const float gnorm = CLIP ? s_gnorm : 0.f;
  const bool scale = CLIP && !(gnorm < c.grad_clip);
  constexpr int step = kThreads * kVec;

  if (ch[5]) {  // vector chunk: n / 4 float4s, 16-byte aligned in all four
    const int n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int base = threadIdx.x; base < n4; base += step) {
      float4 P[kVec], G[kVec], M[kVec], V[kVec];
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int i = base + k * kThreads;
        if (i < n4) {
          P[k] = p4[i];
          G[k] = __ldg(g4 + i);
          M[k] = m4[i];
          V[k] = v4[i];
        }
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int i = base + k * kThreads;
        if (i < n4) {
          update<CLIP, L2, DECAY, MODE>(P[k].x, G[k].x, M[k].x, V[k].x, c, scale, gnorm);
          update<CLIP, L2, DECAY, MODE>(P[k].y, G[k].y, M[k].y, V[k].y, c, scale, gnorm);
          update<CLIP, L2, DECAY, MODE>(P[k].z, G[k].z, M[k].z, V[k].z, c, scale, gnorm);
          update<CLIP, L2, DECAY, MODE>(P[k].w, G[k].w, M[k].w, V[k].w, c, scale, gnorm);
          p4[i] = P[k];
          m4[i] = M[k];
          v4[i] = V[k];
        }
      }
    }
    return;
  }
  for (int base = threadIdx.x; base < n; base += step) {  // scalar chunk
    float P[kVec], G[kVec], M[kVec], V[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = base + k * kThreads;
      if (i < n) {
        P[k] = p[i];
        G[k] = __ldg(g + i);
        M[k] = m[i];
        V[k] = v[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int i = base + k * kThreads;
      if (i < n) {
        update<CLIP, L2, DECAY, MODE>(P[k], G[k], M[k], V[k], c, scale, gnorm);
        p[i] = P[k];
        m[i] = M[k];
        v[i] = V[k];
      }
    }
  }
}

using Kernel = void (*)(const long long*, const float*, Coef);

// variant I: bit 0 clip, bit 1 classic L2, bit 2 decoupled decay, I / 8 the
// mode
template <int I>
Kernel kernel_at() {
  return &fused_update<(I & 1) != 0, (I & 2) != 0, (I & 4) != 0, I / 8>;
}

template <int... I>
std::array<Kernel, sizeof...(I)> kernel_table(std::integer_sequence<int, I...>) {
  return {{kernel_at<I>()...}};
}

}  // namespace

// chunks [n_chunks, 6] int64: each chunk's p, g, m, v device addresses (f32,
// at its first element), its length (at most 2^31 - 1) and 1 for a vector
// chunk (all four addresses 16-byte aligned, length a multiple of 4) or 0;
// gnorm one f32 on the device, read only when grad_clip > 0 (may be null
// otherwise); mode 0 Adam, 1 RAdam rectified (rect used), 2 RAdam
// unrectified. p, m and v are updated in place.
extern "C" int srt_fused_update(const void* chunks, int n_chunks, const void* gnorm, float b1c,
                                float b1, float b2c, float b2, float eps, float grad_clip, float l2_grad, float l2_decay,
                                int mode, float bc1, float bc2, float step_size, float rect,
                                int device, void* stream) {
  static const auto kKernels = kernel_table(std::make_integer_sequence<int, 24>());
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_chunks == 0) return 0;
  if (mode < 0 || mode > 2 || (grad_clip > 0.f && gnorm == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Coef c{b1c, b1, b2c, b2, eps, grad_clip, l2_grad, l2_decay, bc1, bc2, step_size, rect};
  const int variant = (grad_clip > 0.f ? 1 : 0) + (l2_grad != 0.f ? 2 : 0) +
                      (l2_decay != 0.f ? 4 : 0) + 8 * mode;
  kKernels[variant]<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(chunks), static_cast<const float*>(gnorm), c);
  return static_cast<int>(cudaGetLastError());
}
