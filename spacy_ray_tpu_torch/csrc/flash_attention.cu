// Flash attention forward with an additive key-padding bias.
//
//   s[q, k] = (q . k) * scale + bias[b, k]
//   o[q]    = sum_k softmax_k(s[q, :]) v[k]        lse[q] = logsumexp_k s[q, :]
//
// Replaces the TPU kernel spacy_ray_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd_raw). That kernel holds a whole head's K/V in VMEM, pads
// the head dim to 128 lanes and the sequence to 128 rows, and forms one
// [128, T] score block. Here q/k/v stay in the trunk's [B, T, H, Dh] layout
// (any batch/time strides, heads and head dim contiguous), Dh is the real
// head dim, and keys stream through shared memory in tiles with an online
// softmax, so nothing is padded and no score row reaches device memory.
//
// Bound on the H100: bytes at serving shapes (B*T*H*Dh*2 bytes per tensor in
// bf16 against 4*B*H*T*T*Dh operations: T = 128 and 512 are both below the
// card's ~295 operations per byte). This first version does its arithmetic
// in f32 on the CUDA cores, not in wgmma, and is operation-limited in
// practice; the tensor-core version is a later change.
//
// Design: one CTA per (batch, head, 64-query block), 4 threads per query,
// each owning every 4th element of the head dim (so a warp reads 4
// neighbouring shared-memory words per key, a broadcast with no bank
// conflict). Per 32-key tile: load K and V (upcast to f32) and the bias into
// shared memory; each query's 4 threads form partial dots, combine them with
// two xor-shuffles, keep the tile max, park the scores in shared memory;
// then rescale the running sum and accumulator once per tile and add
// p * v. Accumulation is f32 throughout; the output is cast to the input
// type and the log-sum-exp is written in f32.
//
// Batch-padding rows have every key masked. With the finite -1e30 bias
// (never -inf) their scores are all equal, so they get a finite uniform
// average instead of 0/0: a NaN there would survive the trunk's final
// multiply by the mask.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;      // queries per CTA
constexpr int kBK = 32;      // keys per shared-memory tile
constexpr int kLanes = 4;    // threads per query
constexpr int kThreads = kBQ * kLanes;

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse,
          int T_len, int H, long long q_sb, long long q_st, long long k_sb,
          long long k_st, long long v_sb, long long v_st, float scale) {
  constexpr int PER = DH / kLanes;
  __shared__ float ks[kBK][DH];
  __shared__ float vs[kBK][DH];
  __shared__ float ss[kBQ][kBK + 1];
  __shared__ float bs[kBK];

  const int tid = threadIdx.x;
  const int qi = tid / kLanes;
  const int part = tid % kLanes;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int t = blockIdx.y * kBQ + qi;
  const bool active = t < T_len;

  float qr[PER];
  float acc[PER];
  const T* qp = q + b * q_sb + static_cast<long long>(active ? t : 0) * q_st + h * DH;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    qr[i] = active ? srt::to_f32(qp[part + kLanes * i]) : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const T* kb = k + b * k_sb + h * DH;
  const T* vb = v + b * v_sb + h * DH;
  const float* biasb = bias + static_cast<long long>(b) * T_len;

  for (int k0 = 0; k0 < T_len; k0 += kBK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < kBK * DH; idx += kThreads) {
      const int r = idx / DH;
      const int c = idx % DH;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < T_len) {
        kv = srt::to_f32(kb[key * k_st + c]);
        vv = srt::to_f32(vb[key * v_st + c]);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    if (tid < kBK) bs[tid] = (k0 + tid < T_len) ? biasb[k0 + tid] : 0.f;
    __syncthreads();

    const int nk = min(kBK, T_len - k0);
    float tile_max = -INFINITY;
    for (int j = 0; j < nk; ++j) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) d = fmaf(qr[i], ks[j][part + kLanes * i], d);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const float s = d * scale + bs[j];
      tile_max = fmaxf(tile_max, s);
      if ((j % kLanes) == part) ss[qi][j] = s;
    }
    __syncwarp();
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);  // 0 on the first tile (m = -inf)
    l *= alpha;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[i] *= alpha;
    for (int j = 0; j < nk; ++j) {
      const float p = expf(ss[qi][j] - m_new);
      l += p;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] = fmaf(p, vs[j][part + kLanes * i], acc[i]);
    }
    m = m_new;
  }

  if (active) {
    const long long row = (static_cast<long long>(b) * T_len + t) * H + h;
    T* op = o + row * DH;
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < PER; ++i) op[part + kLanes * i] = srt::from_f32<T>(acc[i] * inv);
    if (part == 0) lse[row] = m + logf(l);
  }
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, const void* bias, void* o,
            void* lse, int B, int T_len, int H, const long long* strides,
            float scale, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((T_len + kBQ - 1) / kBQ));
  flash_fwd<T, DH><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<T*>(o), static_cast<float*>(lse),
      T_len, H, strides[0], strides[1], strides[2], strides[3], strides[4],
      strides[5], scale);
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, const void* bias,
             void* o, void* lse, int B, int T_len, int H, const long long* strides,
             float scale, cudaStream_t s) {
  switch (dh) {
    case 16: launch<T, 16>(q, k, v, bias, o, lse, B, T_len, H, strides, scale, s); break;
    case 64: launch<T, 64>(q, k, v, bias, o, lse, B, T_len, H, strides, scale, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v [B, T, H, Dh] with (batch, time) element strides given, heads and the
// head dim contiguous; bias [B, T] f32; o [B, T, H, Dh] contiguous in the
// input type; lse [B, T, H] f32. dtype: 0 = float32, 1 = bfloat16.
extern "C" int srt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, void* o,
    void* lse, int B, int T_len, int H, int dh, long long q_sb, long long q_st,
    long long k_sb, long long k_st, long long v_sb, long long v_st, float scale,
    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || T_len == 0 || H == 0) return 0;
  const long long strides[6] = {q_sb, q_st, k_sb, k_st, v_sb, v_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(dh, q, k, v, bias, o, lse, B, T_len, H, strides, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(dh, q, k, v, bias, o, lse, B, T_len, H, strides,
                                   scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
