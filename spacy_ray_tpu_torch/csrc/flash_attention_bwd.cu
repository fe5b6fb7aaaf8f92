// Flash attention backward with an additive key-padding bias and an lse
// cotangent, for the forward of flash_attention.cu:
//
//   p[q, k]  = exp(s[q, k] - lse[q])          s = (q . k) * scale + bias[b, k]
//   delta[q] = sum_d do[q, d] * o[q, d]
//   ds[q, k] = p * (do[q] . v[k] - delta[q] + dlse[q]) * scale
//   dq[q] = sum_k ds[q, k] k[k]    dk[k] = sum_q ds[q, k] q[q]    dv[k] = sum_q p[q, k] do[q]
//
// Replaces the TPU kernel spacy_ray_tpu/ops/flash_attention.py::_bwd_kernel
// (launched by _bwd_raw). That kernel keeps a head's whole K/V in VMEM and
// accumulates dk/dv in its output blocks while the grid revisits them query
// block by query block, in order. On the card blocks run in no order and
// nothing carries over between them, so that accumulation cannot be carried
// over.
//
// Bound on the H100: bytes at the training shapes (q, k, v, o, do read and
// dq, dk, dv written, 8 * B*T*H*Dh elements, against about 8 * B*H*T*T*Dh
// operations: T = 128 is below the card's ~295 operations per byte). Like
// the forward, this first version does its arithmetic in f32 on the CUDA
// cores, not in wgmma, and recomputes the scores in both passes, so in
// practice it is limited by operations; the tensor-core version is a later
// change.
//
// Design, deterministic with no atomics, in two passes on one stream:
//
// 1. Query-major (flash_bwd_dq): one CTA per (batch, head, 64 queries), 4
//    threads per query, each owning every 4th element of the head dim. It
//    forms delta from the query's do and o, writes it, then streams 32-key
//    tiles of K, V and the bias through shared memory, recomputes p from lse
//    and sums dq in registers.
// 2. Key-major (flash_bwd_dkdv): one CTA per (batch, head, 64 keys), 4
//    threads per key. It streams 32-query tiles of q, do, lse, delta and dlse
//    through shared memory and sums dk and dv in registers, so each key's
//    gradient is summed by one thread group in query order.
//
// Accumulation is f32 throughout; dq, dk and dv are cast to the input type.
// Rows whose keys are all masked (batch padding) stay finite: the finite
// -1e30 bias makes their scores equal, and p is recomputed from the same lse
// the forward wrote.
#include "common.cuh"

namespace {

constexpr int kLanes = 4;     // threads per query (pass 1) or key (pass 2)
constexpr int kRows = 64;     // queries (pass 1) or keys (pass 2) per CTA
constexpr int kTile = 32;     // keys (pass 1) or queries (pass 2) per smem tile
constexpr int kThreads = kRows * kLanes;

__device__ __forceinline__ float lane_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

struct Strides {
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st;
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ bias, const T* __restrict__ o,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ dlse, T* __restrict__ dq,
             float* __restrict__ delta, int T_len, int H, Strides st, float scale) {
  constexpr int PER = DH / kLanes;
  __shared__ float ks[kTile][DH];
  __shared__ float vs[kTile][DH];
  __shared__ float bs[kTile];

  const int tid = threadIdx.x;
  const int qi = tid / kLanes;
  const int part = tid % kLanes;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int t = blockIdx.y * kRows + qi;
  const bool active = t < T_len;
  const int tc = active ? t : 0;
  const long long row = (static_cast<long long>(b) * T_len + tc) * H + h;

  float qr[PER], dor[PER], acc[PER];
  const T* qp = q + b * st.q_sb + static_cast<long long>(tc) * st.q_st + h * DH;
  const T* op = o + row * DH;
  const T* dop = dout + row * DH;
  float dl = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = part + kLanes * i;
    qr[i] = active ? srt::to_f32(qp[c]) : 0.f;
    dor[i] = active ? srt::to_f32(dop[c]) : 0.f;
    dl = fmaf(dor[i], active ? srt::to_f32(op[c]) : 0.f, dl);
    acc[i] = 0.f;
  }
  const float dlt = lane_sum(dl);
  const float lse_q = active ? lse[row] : 0.f;
  const float dlse_q = (active && dlse != nullptr) ? dlse[row] : 0.f;
  if (active && part == 0) delta[row] = dlt;

  const T* kb = k + b * st.k_sb + h * DH;
  const T* vb = v + b * st.v_sb + h * DH;
  const float* biasb = bias + static_cast<long long>(b) * T_len;

  for (int k0 = 0; k0 < T_len; k0 += kTile) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < kTile * DH; idx += kThreads) {
      const int r = idx / DH;
      const int c = idx % DH;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < T_len) {
        kv = srt::to_f32(kb[key * st.k_st + c]);
        vv = srt::to_f32(vb[key * st.v_st + c]);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    if (tid < kTile) bs[tid] = (k0 + tid < T_len) ? biasb[k0 + tid] : 0.f;
    __syncthreads();

    const int nk = min(kTile, T_len - k0);
    for (int j = 0; j < nk; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        s = fmaf(qr[i], ks[j][part + kLanes * i], s);
        dp = fmaf(dor[i], vs[j][part + kLanes * i], dp);
      }
      s = lane_sum(s) * scale + bs[j];
      dp = lane_sum(dp);
      const float p = expf(s - lse_q);
      const float ds = p * (dp - dlt + dlse_q) * scale;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[i] = fmaf(ds, ks[j][part + kLanes * i], acc[i]);
    }
  }

  if (active) {
    T* dqp = dq + row * DH;
#pragma unroll
    for (int i = 0; i < PER; ++i) dqp[part + kLanes * i] = srt::from_f32<T>(acc[i]);
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ bias, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dlse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
               int T_len, int H, Strides st, float scale) {
  constexpr int PER = DH / kLanes;
  __shared__ float qs[kTile][DH];
  __shared__ float dos[kTile][DH];
  __shared__ float ls[kTile];   // lse, per query
  __shared__ float ds_[kTile];  // delta, per query
  __shared__ float dls[kTile];  // dlse, per query

  const int tid = threadIdx.x;
  const int kj = tid / kLanes;
  const int part = tid % kLanes;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int key = blockIdx.y * kRows + kj;
  const bool active = key < T_len;
  const int kc = active ? key : 0;

  float kr[PER], vr[PER], dka[PER], dva[PER];
  const T* kp = k + b * st.k_sb + static_cast<long long>(kc) * st.k_st + h * DH;
  const T* vp = v + b * st.v_sb + static_cast<long long>(kc) * st.v_st + h * DH;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = part + kLanes * i;
    kr[i] = active ? srt::to_f32(kp[c]) : 0.f;
    vr[i] = active ? srt::to_f32(vp[c]) : 0.f;
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  const float bias_k = active ? bias[static_cast<long long>(b) * T_len + kc] : 0.f;

  const T* qb = q + b * st.q_sb + h * DH;
  const long long row0 = static_cast<long long>(b) * T_len * H + h;  // (b, 0, h)

  for (int q0 = 0; q0 < T_len; q0 += kTile) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < kTile * DH; idx += kThreads) {
      const int r = idx / DH;
      const int c = idx % DH;
      const int qt = q0 + r;
      float qv = 0.f, dv_ = 0.f;
      if (qt < T_len) {
        qv = srt::to_f32(qb[qt * st.q_st + c]);
        dv_ = srt::to_f32(dout[(row0 + static_cast<long long>(qt) * H) * DH + c]);
      }
      qs[r][c] = qv;
      dos[r][c] = dv_;
    }
    if (tid < kTile) {
      const int qt = q0 + tid;
      if (qt < T_len) {
        const long long row = row0 + static_cast<long long>(qt) * H;
        ls[tid] = lse[row];
        ds_[tid] = delta[row];
        dls[tid] = dlse != nullptr ? dlse[row] : 0.f;
      } else {
        ls[tid] = 0.f;
        ds_[tid] = 0.f;
        dls[tid] = 0.f;
      }
    }
    __syncthreads();

    const int nq = min(kTile, T_len - q0);
    for (int i = 0; i < nq; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        s = fmaf(kr[e], qs[i][part + kLanes * e], s);
        dp = fmaf(vr[e], dos[i][part + kLanes * e], dp);
      }
      s = lane_sum(s) * scale + bias_k;
      dp = lane_sum(dp);
      const float p = expf(s - ls[i]);
      const float ds = p * (dp - ds_[i] + dls[i]) * scale;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        dva[e] = fmaf(p, dos[i][part + kLanes * e], dva[e]);
        dka[e] = fmaf(ds, qs[i][part + kLanes * e], dka[e]);
      }
    }
  }

  if (active) {
    const long long row = (static_cast<long long>(b) * T_len + key) * H + h;
    T* dkp = dk + row * DH;
    T* dvp = dv + row * DH;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      dkp[part + kLanes * i] = srt::from_f32<T>(dka[i]);
      dvp[part + kLanes * i] = srt::from_f32<T>(dva[i]);
    }
  }
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, const void* bias, const void* o,
            const void* dout, const void* lse, const void* dlse, void* dq, void* dk,
            void* dv, void* delta, int B, int T_len, int H, const Strides& st,
            float scale, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((T_len + kRows - 1) / kRows));
  flash_bwd_dq<T, DH><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dlse), static_cast<T*>(dq), static_cast<float*>(delta),
      T_len, H, st, scale);
  flash_bwd_dkdv<T, DH><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dlse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), T_len,
      H, st, scale);
}

template <typename T>
int dispatch(int dh, const void* q, const void* k, const void* v, const void* bias,
             const void* o, const void* dout, const void* lse, const void* dlse, void* dq,
             void* dk, void* dv, void* delta, int B, int T_len, int H, const Strides& st,
             float scale, cudaStream_t s) {
  switch (dh) {
    case 16:
      launch<T, 16>(q, k, v, bias, o, dout, lse, dlse, dq, dk, dv, delta, B, T_len, H,
                    st, scale, s);
      break;
    case 64:
      launch<T, 64>(q, k, v, bias, o, dout, lse, dlse, dq, dk, dv, delta, B, T_len, H,
                    st, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v [B, T, H, Dh] with (batch, time) element strides given, heads and the
// head dim contiguous; bias [B, T] f32; o, dout, dq, dk, dv [B, T, H, Dh]
// contiguous in the input type; lse, delta [B, T, H] f32 (delta is written
// by the first pass and read by the second); dlse [B, T, H] f32 or null for a
// zero lse cotangent. dtype: 0 = float32, 1 = bfloat16.
extern "C" int srt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* o,
    const void* dout, const void* lse, const void* dlse, void* dq, void* dk, void* dv,
    void* delta, int B, int T_len, int H, int dh, long long q_sb, long long q_st,
    long long k_sb, long long k_st, long long v_sb, long long v_st, float scale,
    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || T_len == 0 || H == 0) return 0;
  const Strides st{q_sb, q_st, k_sb, k_st, v_sb, v_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(dh, q, k, v, bias, o, dout, lse, dlse, dq, dk, dv, delta, B,
                           T_len, H, st, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(dh, q, k, v, bias, o, dout, lse, dlse, dq, dk, dv,
                                   delta, B, T_len, H, st, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
