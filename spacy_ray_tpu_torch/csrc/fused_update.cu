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
// Design: the wrapper builds, once per parameter set, a device table of each
// leaf's (p, g, m, v, n) and a list of fixed-size chunks (leaf, start). One
// CTA takes one chunk, so one launch walks every leaf with no padding and no
// per-leaf launch. The six step scalars of _update_kernel arrive by value,
// except the gradient's global norm, which stays on the device (a pointer)
// so the host never waits for it.
//
// The expression order is _leaf_math's, term for term. This source is
// compiled with --fmad=false so that no a*b + c becomes an FMA: the result
// is then bit-equal to the plain PyTorch version (separate elementwise ops,
// each rounded) and to the reference run op by op. Division and sqrt are the
// IEEE-rounded ones (nvcc's default without fast math). The coefficients
// (1 - b1), (1 - b2), eps and the L2 and clip constants arrive as the f32
// roundings of the Python doubles, as JAX's weak-typed constants are.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float b1c, b1, b2c, b2, eps, grad_clip, l2_grad, l2_decay, radam_threshold;
  int radam;
};

struct Step {
  float bc1, bc2, step_size, ro, rect;
};

__global__ void __launch_bounds__(kThreads)
fused_update(const long long* __restrict__ leaves, const long long* __restrict__ chunks,
             int chunk, const float* __restrict__ gnorm_p, Hyper hp, Step sc) {
  const long long leaf = chunks[2 * blockIdx.x];
  const long long start = chunks[2 * blockIdx.x + 1];
  const long long* L = leaves + 5 * leaf;
  float* p = reinterpret_cast<float*>(L[0]);
  const float* g = reinterpret_cast<const float*>(L[1]);
  float* m = reinterpret_cast<float*>(L[2]);
  float* v = reinterpret_cast<float*>(L[3]);
  const long long stop = start + static_cast<long long>(chunk);
  const long long end = stop < L[4] ? stop : L[4];
  const float gnorm = hp.grad_clip > 0.f ? *gnorm_p : 0.f;
  for (long long i = start + threadIdx.x; i < end; i += kThreads) {
    const float pi = p[i];
    float gi = g[i];
    if (hp.grad_clip > 0.f) gi = gnorm < hp.grad_clip ? gi : (gi / gnorm) * hp.grad_clip;
    if (hp.l2_grad != 0.f) gi = gi + hp.l2_grad * pi;
    const float m2 = hp.b1c * gi + hp.b1 * m[i];
    const float v2 = hp.b2c * (gi * gi) + hp.b2 * v[i];
    const float mu_hat = m2 / sc.bc1;
    const float nu_hat = v2 / sc.bc2;
    float u;
    if (hp.radam) {
      u = sc.ro >= hp.radam_threshold ? sc.rect * mu_hat / (sqrtf(nu_hat) + hp.eps) : mu_hat;
    } else {
      u = mu_hat / (sqrtf(nu_hat) + hp.eps);
    }
    if (hp.l2_decay != 0.f) u = u + hp.l2_decay * pi;
    u = sc.step_size * u;
    p[i] = pi + u;
    m[i] = m2;
    v[i] = v2;
  }
}

}  // namespace

// leaves [n_leaves, 5] int64: the device addresses of each leaf's p, g, m, v
// (f32, contiguous) and its element count; chunks [n_chunks, 2] int64: (leaf,
// first element) of each chunk of `chunk` elements; gnorm: one f32 on the
// device, read only when grad_clip > 0 (may be null otherwise). p, m and v
// are updated in place.
extern "C" int srt_fused_update(const void* leaves, const void* chunks, int n_chunks,
                                int chunk, const void* gnorm, float b1c, float b1,
                                float b2c, float b2, float eps, float grad_clip,
                                float l2_grad, float l2_decay, float radam_threshold,
                                int radam, float bc1, float bc2, float step_size,
                                float ro, float rect, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_chunks == 0) return 0;
  if (chunk <= 0 || (grad_clip > 0.f && gnorm == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper hp{b1c, b1, b2c, b2, eps, grad_clip, l2_grad, l2_decay, radam_threshold,
                 radam};
  const Step sc{bc1, bc2, step_size, ro, rect};
  fused_update<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(leaves), static_cast<const long long*>(chunks), chunk,
      static_cast<const float*>(gnorm), hp, sc);
  return static_cast<int>(cudaGetLastError());
}
