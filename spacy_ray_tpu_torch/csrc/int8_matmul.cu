// Weight-only int8 matmul: out[M, N] = (x[M, K] @ f32(q8[K, N])) * scale[N]
//
// Replaces the TPU kernel spacy_ray_tpu/ops/int8_matmul.py::_kernel
// (launched by _int8_matmul_raw), which keeps all of K resident per grid
// step and pads M, N and K to multiples of 128. Here K is tiled and the
// ragged edges are masked in the kernel, so nothing is padded or copied.
//
// Bound on the H100: bytes, K*N int8 weights plus the f32 activations in
// and out. On the serving path x holds bf16 values and |q| <= 127, so the
// bf16 tensor cores with f32 accumulation would compute this exactly at
// 989 TFLOP/s, and the arithmetic is never what bounds it. This first
// version does its arithmetic as f32 FMA on the CUDA cores (67 TFLOP/s),
// so at M = B*T ~ 1000 it is limited by operations in practice; mma is a
// later change.
//
// Design: a 64x64 output tile per CTA of 128 threads; each thread owns 8
// rows (strided by 8) by 4 adjacent columns. Per 32-deep K step the x tile
// is staged row-major in f32 (float4 loads and stores, row pitch 36 words:
// conflict free both ways) and the q8 tile stays int8 in shared memory, 4
// columns to a 32-bit word. The inner loop reads 4 k of x per row as one
// float4 and one word of q8 per k, and upcasts the 4 int8 in registers with
// a byte permute and one f32 subtract (0x4B0000uu is 2^23 + uu), which is
// cheaper than I2F; each upcast feeds 8 FMA. Accumulation is f32 and the
// per-channel scale is applied once in the epilogue ((x @ q) * s ==
// x @ (q * s) because s is constant down each column).
//
// At serving M the output has few 64x64 tiles (M = 64, N = 768: 12 CTAs
// for 132 SMs), so K is split across blockIdx.z until about two CTAs per
// SM are in flight; each split writes an unscaled partial and a second
// kernel adds the splits in a fixed order (deterministic) and scales.
#include "common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 128;
constexpr int kRows = kBM / (kThreads / (kBN / 4));  // 8 rows per thread
constexpr int kXP = kBK + 4;                         // x tile row pitch, words

// The int8 in byte j of w (already xor 0x80808080) as an exact f32.
__device__ __forceinline__ float byte_to_f32(uint32_t w, int j) {
  const uint32_t bits = __byte_perm(w, 0x4B000000u, 0x7440u | j);
  return __uint_as_float(bits) - 8388736.f;  // 2^23 + 128
}

// blockIdx.z takes the K range [z*k_chunk, (z+1)*k_chunk). With one split
// the scaled tile goes to out; with more, the unscaled partial goes to
// part[z] and reduce_splits adds the splits in order.
__global__ void __launch_bounds__(kThreads)
int8_weight_mm(const float* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, float* __restrict__ out,
               float* __restrict__ part, int M, int N, int K, int k_chunk, bool vec_x,
               bool vec_w, bool vec_out) {
  __shared__ __align__(16) float xs[kBM][kXP];
  __shared__ uint32_t ws[kBK][kBN / 4];
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / 4);  // columns 4*tx .. 4*tx+3
  const int ty = tid / (kBN / 4);  // rows ty + 8*i
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int k_lo = blockIdx.z * k_chunk;
  const int k_hi = min(K, k_lo + k_chunk);
  float acc[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    // x tile: 64 rows x 8 float4, consecutive threads along a row
#pragma unroll
    for (int i = 0; i < (kBM * kBK / 4) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBK / 4);
      const int c = 4 * (idx % (kBK / 4));
      const int gm = m0 + r;
      const int gk = k0 + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gm < M) {
        const float* src = x + static_cast<long long>(gm) * K + gk;
        if (vec_x && gk + 3 < k_hi) {
          v = *reinterpret_cast<const float4*>(src);
        } else {
          if (gk < k_hi) v.x = src[0];
          if (gk + 1 < k_hi) v.y = src[1];
          if (gk + 2 < k_hi) v.z = src[2];
          if (gk + 3 < k_hi) v.w = src[3];
        }
      }
      *reinterpret_cast<float4*>(&xs[r][c]) = v;
    }
    // q8 tile: 32 rows x 16 words of 4 int8, stored xor 0x80 per byte
#pragma unroll
    for (int i = 0; i < (kBK * kBN / 4) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBN / 4);
      const int c = idx % (kBN / 4);
      const int gk = k0 + r;
      const int gn = n0 + 4 * c;
      uint32_t word = 0;
      if (gk < k_hi) {
        const int8_t* src = w + static_cast<long long>(gk) * N + gn;
        if (vec_w && gn + 3 < N) {
          word = *reinterpret_cast<const uint32_t*>(src);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gn + j < N) word |= static_cast<uint32_t>(static_cast<uint8_t>(src[j])) << (8 * j);
        }
      }
      ws[r][c] = word ^ 0x80808080u;
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        a[i] = *reinterpret_cast<const float4*>(&xs[ty + 8 * i][kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint32_t word = ws[kk + t][tx];
        float b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = byte_to_f32(word, j);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float av = t == 0 ? a[i].x : t == 1 ? a[i].y : t == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  const int gn = n0 + 4 * tx;
  if (gn >= N) return;
  float s[4] = {1.f, 1.f, 1.f, 1.f};
  float* base = out;
  if (part == nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = gn + j < N ? scale[gn + j] : 0.f;
  } else {
    base = part + static_cast<long long>(blockIdx.z) * M * N;
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int gm = m0 + ty + 8 * i;
    if (gm >= M) continue;
    float* dst = base + static_cast<long long>(gm) * N + gn;
    if (vec_out && gn + 3 < N) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[i][0] * s[0], acc[i][1] * s[1], acc[i][2] * s[2], acc[i][3] * s[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) dst[j] = acc[i][j] * s[j];
    }
  }
}

// out[m, n] = scale[n] * sum over z in order of part[z, m, n]
__global__ void reduce_splits(const float* __restrict__ part, const float* __restrict__ scale,
                              float* __restrict__ out, int M, int N, int splits) {
  const long long total = static_cast<long long>(M) * N;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += part[z * total + i];
    out[i] = acc * scale[i % N];
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x [M, K] f32, q8 [K, N] int8, scale [N] f32, out [M, N] f32; all contiguous.
// K is cut into splits ranges of k_chunk (a multiple of 32); with splits > 1,
// part is an f32 workspace of [splits, M, N] and a second kernel reduces it.
extern "C" int srt_int8_weight_matmul(const void* x, const void* q8, const void* scale,
                                      void* out, void* part, int M, int N, int K,
                                      int splits, int k_chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M == 0 || N == 0) return 0;
  if (splits < 1 || k_chunk % kBK != 0 || (splits > 1 && part == nullptr) ||
      static_cast<long long>(splits) * k_chunk < K)
    return static_cast<int>(cudaErrorInvalidValue);
  float* partial = splits > 1 ? static_cast<float*>(part) : nullptr;
  const bool vec_x = K % 4 == 0 && aligned(x, 16);
  const bool vec_w = N % 4 == 0 && aligned(q8, 4);
  const bool vec_out = N % 4 == 0 && aligned(partial ? partial : out, 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + kBM - 1) / kBM), static_cast<unsigned>(splits));
  int8_weight_mm<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q8),
      static_cast<const float*>(scale), static_cast<float*>(out), partial, M, N, K, k_chunk,
      vec_x, vec_w, vec_out);
  if (partial != nullptr) {
    const long long total = static_cast<long long>(M) * N;
    const unsigned blocks = static_cast<unsigned>(min((total + 255) / 256, 4096LL));
    reduce_splits<<<blocks, 256, 0, s>>>(partial, static_cast<const float*>(scale),
                                         static_cast<float*>(out), M, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
