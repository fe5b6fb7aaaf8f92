// Weight-only int8 matmul: out[M, N] = (x[M, K] @ q8[K, N]) * scale[N]
//
// Replaces the TPU kernel spacy_ray_tpu/ops/int8_matmul.py::_kernel
// (launched by _int8_matmul_raw), which keeps all of K resident per grid
// step and pads M, N and K to multiples of 128. Here K is tiled and the
// ragged edges are masked in the kernel, so nothing is padded or copied.
// Accumulation is f32 and the output f32, as the TPU kernel writes it.
//
// Bound on the H100: bytes at serving M (K*N int8 weights, the activations
// in and the f32 output), operations on the tensor cores at large M. The
// products run on the bf16 tensor cores: |q| <= 127 fits bf16's 8-bit
// significand, so the upcast weight is exact, and a bf16 x times it is an
// exact product, accumulated in f32. The first design did the same
// arithmetic as f32 FMA on the CUDA cores (67 TFLOP/s), which held it to
// ~20 TFLOP/s at M 1024 on an H100 SXM (700 W), 1.55-1.95 x cuBLAS f32 on
// the dequantized weight.
//
// x comes in two types:
// - bf16, the serving path's activations: one product per K step.
// - f32 (the CPU precision's compute type): split in registers into
//   hi = bf16(x) and lo = bf16(x - hi), two products into the same
//   accumulators; x - hi is exact in f32 and lo keeps 8 more bits, so at
//   most 2^-18 of |x| is lost per element.
//
// Design: a 128 x 128 output tile per CTA of 8 warps, each warp 64 rows x 32
// columns (4 x 4 mma.sync m16n8k16 tiles, f32 accumulators in registers).
// Per 32-deep K step the x tile and the int8 q8 tile arrive by 16-byte
// cp.async into padded shared tiles, double-buffered (step s+1 is in flight
// while step s is multiplied). Each thread then upcasts 16 weights of the
// current step to bf16 in shared memory (a byte permute and an f32 subtract
// per value, 0x4B0000uu being 2^23 + uu, then one cvt per pair), and the
// warps feed the tensor cores with ldmatrix (.trans for the k-major weight).
// The per-channel scale multiplies the f32 accumulators once ((x @ q) * s ==
// x @ (q * s) down each column); the tile is staged through shared memory
// for 16-byte stores. Rows, columns and K past the edges are zero-filled in
// shared memory by the guarded loads (scalar loads where a row is not
// 16-byte aligned), so no shape is padded.
//
// Where the grid has fewer CTAs than SMs (M 64; M 1024 with N 768), K is
// split across blockIdx.z: each split writes an unscaled partial, and a
// second kernel adds the splits in a fixed order (deterministic) and scales.
#include "common.cuh"
#include "mma.cuh"

namespace {

using srt::bf16;

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kThreads = 256;     // 8 warps: 2 along M x 4 along N
constexpr int kWM = 64;           // rows of a warp
constexpr int kWN = 32;           // columns of a warp
constexpr int kMT = kWM / 16;     // m16 tiles of a warp
constexpr int kNT = kWN / 8;      // n8 tiles of a warp
constexpr int kXS = kBK + 8;      // x tile row stride, elements (ldmatrix rows on distinct banks)
constexpr int kQS = kBN + 16;     // int8 weight tile row stride, bytes
constexpr int kWS = kBN + 8;      // bf16 weight tile row stride, elements
constexpr int kOS = kBN + 8;      // f32 output staging row stride, elements

template <typename XT>
struct Tiles {
  XT x[2][kBM][kXS];
  int8_t q[2][kBK][kQS];
  bf16 w[kBK][kWS];
};

template <typename XT>
constexpr int smem_bytes() {
  return sizeof(Tiles<XT>) > kBM * kOS * 4 ? static_cast<int>(sizeof(Tiles<XT>)) : kBM * kOS * 4;
}

// The int8 in byte j of w (already xor 0x80808080) as an exact f32.
__device__ __forceinline__ float byte_to_f32(uint32_t w, int j) {
  const uint32_t bits = __byte_perm(w, 0x4B000000u, 0x7440u | j);
  return __uint_as_float(bits) - 8388736.f;  // 2^23 + 128
}

// x rows [m0, m0 + 128) x K columns [k0, k0 + 32) into a [128][kXS] tile;
// rows >= M and columns >= k_hi are zeros
template <typename XT>
__device__ __forceinline__ void load_x(XT* dst, const XT* x, int M, int K, int m0, int k0,
                                       int k_hi, bool vec, int tid) {
  constexpr int E = 16 / sizeof(XT);  // elements per 16 bytes
  constexpr int kChunks = kBK / E;    // 16-byte chunks per tile row
  if (vec) {  // K a multiple of E: a chunk is all in or all out
#pragma unroll
    for (int i = 0; i < kBM * kChunks / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kChunks;
      const int col = (c % kChunks) * E;
      const bool ok = m0 + r < M && k0 + col < k_hi;
      srt::cp_async16(dst + r * kXS + col,
                      ok ? x + static_cast<long long>(m0 + r) * K + k0 + col : x, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kBM * kBK / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kBK;
      const int col = c % kBK;
      dst[r * kXS + col] = m0 + r < M && k0 + col < k_hi
                               ? x[static_cast<long long>(m0 + r) * K + k0 + col]
                               : srt::from_f32<XT>(0.f);
    }
  }
}

// q8 rows [k0, k0 + 32) x columns [n0, n0 + 128) into a [32][kQS] tile
__device__ __forceinline__ void load_q(int8_t* dst, const int8_t* w, int N, int n0, int k0,
                                       int k_hi, bool vec, int tid) {
  if (vec) {  // N a multiple of 16: one chunk per thread
    const int r = tid / (kBN / 16);
    const int col = (tid % (kBN / 16)) * 16;
    const bool ok = k0 + r < k_hi && n0 + col < N;
    srt::cp_async16(dst + r * kQS + col,
                    ok ? w + static_cast<long long>(k0 + r) * N + n0 + col : w, ok);
  } else {
#pragma unroll 4
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / kBN;
      const int col = c % kBN;
      dst[r * kQS + col] = k0 + r < k_hi && n0 + col < N
                               ? w[static_cast<long long>(k0 + r) * N + n0 + col]
                               : static_cast<int8_t>(0);
    }
  }
}

// hi = bf16(v), lo = bf16(v - hi), each as a bf16 pair (the first value low)
__device__ __forceinline__ void split_bf16(float2 v, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __float22bfloat162_rn(v);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = srt::pack_bf16(v.x - hf.x, v.y - hf.y);
}

// blockIdx.z takes the K range [z*k_chunk, (z+1)*k_chunk). With one split
// the scaled tile goes to out; with more, the unscaled partial goes to
// part[z] and reduce_splits adds the splits in order.
template <typename XT>
__global__ void __launch_bounds__(kThreads, 2)
int8_weight_mma(const XT* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out,
                float* __restrict__ part, int M, int N, int K, int k_chunk, bool vec_x,
                bool vec_w, bool vec_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tiles<XT>& sm = *reinterpret_cast<Tiles<XT>*>(smem_raw);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int wm = (warp / 4) * kWM;  // the warp's first row and column in the tile
  const int wn = (warp % 4) * kWN;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int k_lo = blockIdx.z * k_chunk;
  const int k_hi = min(K, k_lo + k_chunk);
  const int steps = (k_hi - k_lo + kBK - 1) / kBK;

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  auto load_stage = [&](int buf, int k0) {
    load_x<XT>(&sm.x[buf][0][0], x, M, K, m0, k0, k_hi, vec_x, tid);
    load_q(&sm.q[buf][0][0], w, N, n0, k0, k_hi, vec_w, tid);
  };
  if (steps > 0) load_stage(0, k_lo);
  srt::cp_async_commit();

  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    srt::cp_async_wait<0>();  // step s has landed
    __syncthreads();          // and every warp is done with step s - 1
    if (s + 1 < steps) load_stage(buf ^ 1, k_lo + (s + 1) * kBK);
    srt::cp_async_commit();
    {  // upcast 16 weights per thread: int8 -> exact f32 -> bf16
      const int r = tid / (kBN / 16);
      const int col = (tid % (kBN / 16)) * 16;
      const uint4 q4 = *reinterpret_cast<const uint4*>(&sm.q[buf][r][col]);
      const uint32_t words[4] = {q4.x ^ 0x80808080u, q4.y ^ 0x80808080u, q4.z ^ 0x80808080u,
                                 q4.w ^ 0x80808080u};
      uint32_t packed[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        packed[2 * i] = srt::pack_bf16(byte_to_f32(words[i], 0), byte_to_f32(words[i], 1));
        packed[2 * i + 1] = srt::pack_bf16(byte_to_f32(words[i], 2), byte_to_f32(words[i], 3));
      }
      uint4* dst = reinterpret_cast<uint4*>(&sm.w[r][col]);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[kNT][2];
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        uint32_t r[4];
        srt::ldsm_x4_t(r, &sm.w[kk][wn + np * 16] + srt::frag_bk_offset(lane, kWS));
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        if constexpr (sizeof(XT) == 2) {
          uint32_t a[4];
          srt::ldsm_x4(a, &sm.x[buf][wm + mt * 16][kk] + srt::frag_a_offset(lane, kXS));
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) srt::mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
        } else {
          // a0 = A[g][c2..], a1 = A[g+8][c2..], a2 = A[g][c2+8..], a3 = A[g+8][c2+8..]
          const float* p = &sm.x[buf][wm + mt * 16 + g][kk + c2];
          const float2 v[4] = {*reinterpret_cast<const float2*>(p),
                               *reinterpret_cast<const float2*>(p + 8 * kXS),
                               *reinterpret_cast<const float2*>(p + 8),
                               *reinterpret_cast<const float2*>(p + 8 * kXS + 8)};
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_bf16(v[i], hi[i], lo[i]);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            srt::mma_bf16(acc[mt][nt], hi, b[nt][0], b[nt][1]);
            srt::mma_bf16(acc[mt][nt], lo, b[nt][0], b[nt][1]);
          }
        }
      }
    }
  }
  srt::cp_async_wait<0>();
  __syncthreads();  // the tiles' memory becomes the output stage

  // scaled (or, for a split, unscaled) accumulators into a [128][kOS] f32 stage
  float* stage = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = wn + nt * 8 + c2;
    float s0 = 1.f, s1 = 1.f;
    if (part == nullptr) {
      s0 = n0 + col < N ? scale[n0 + col] : 0.f;
      s1 = n0 + col + 1 < N ? scale[n0 + col + 1] : 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int row = wm + mt * 16 + g;
      *reinterpret_cast<float2*>(stage + row * kOS + col) =
          make_float2(acc[mt][nt][0] * s0, acc[mt][nt][1] * s1);
      *reinterpret_cast<float2*>(stage + (row + 8) * kOS + col) =
          make_float2(acc[mt][nt][2] * s0, acc[mt][nt][3] * s1);
    }
  }
  __syncthreads();
  float* base = part == nullptr ? out : part + static_cast<long long>(blockIdx.z) * M * N;
#pragma unroll 4
  for (int i = 0; i < kBM * kBN / 4 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / (kBN / 4);
    const int col = (c % (kBN / 4)) * 4;
    const int gm = m0 + r;
    const int gn = n0 + col;
    if (gm >= M || gn >= N) continue;
    const float4 v = *reinterpret_cast<const float4*>(stage + r * kOS + col);
    float* dst = base + static_cast<long long>(gm) * N + gn;
    if (vec_out && gn + 3 < N) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (gn + j < N) dst[j] = e[j];
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

template <typename XT>
cudaError_t launch(const void* x, const void* q8, const void* scale, void* out, float* partial,
                   int M, int N, int K, int splits, int k_chunk, cudaStream_t s) {
  // shared memory above 48 KB needs the kernel's opt-in, once per process
  constexpr int kSmem = smem_bytes<XT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_weight_mma<XT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const bool vec_x = K % (16 / static_cast<int>(sizeof(XT))) == 0 && aligned(x, 16);
  const bool vec_w = N % 16 == 0 && aligned(q8, 16);
  const bool vec_out = N % 4 == 0 && aligned(partial ? partial : out, 16);
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((M + kBM - 1) / kBM), static_cast<unsigned>(splits));
  int8_weight_mma<XT><<<grid, kThreads, kSmem, s>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(q8),
      static_cast<const float*>(scale), static_cast<float*>(out), partial, M, N, K, k_chunk,
      vec_x, vec_w, vec_out);
  return cudaSuccess;
}

}  // namespace

// x [M, K] f32 (x_dtype 0) or bf16 (x_dtype 1), q8 [K, N] int8, scale [N]
// f32, out [M, N] f32; all contiguous. K is cut into splits ranges of
// k_chunk (a multiple of 32); with splits > 1, part is an f32 workspace of
// [splits, M, N] and a second kernel reduces it.
extern "C" int srt_int8_weight_matmul(const void* x, const void* q8, const void* scale,
                                      void* out, void* part, int M, int N, int K,
                                      int splits, int k_chunk, int x_dtype, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M == 0 || N == 0) return 0;
  if (splits < 1 || k_chunk % kBK != 0 || (splits > 1 && part == nullptr) ||
      static_cast<long long>(splits) * k_chunk < K || (x_dtype != 0 && x_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  float* partial = splits > 1 ? static_cast<float*>(part) : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = x_dtype == 1 ? launch<bf16>(x, q8, scale, out, partial, M, N, K, splits, k_chunk, s)
                     : launch<float>(x, q8, scale, out, partial, M, N, K, splits, k_chunk, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (partial != nullptr) {
    const long long total = static_cast<long long>(M) * N;
    const unsigned blocks = static_cast<unsigned>(min((total + 255) / 256, 4096LL));
    reduce_splits<<<blocks, 256, 0, s>>>(partial, static_cast<const float*>(scale),
                                         static_cast<float*>(out), M, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
