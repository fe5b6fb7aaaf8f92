// Flash attention backward with an additive key-padding bias and an lse
// cotangent, for the forward of flash_attention.cu:
//
//   p[q, k]  = exp(s[q, k] - lse[q])          s = (q . k) * scale + bias[b, k]
//   delta[q] = sum_d do[q, d] * o[q, d]
//   ds[q, k] = p * (do[q] . v[k] - delta[q] + dlse[q]) * scale
//   dq[q] = sum_k ds[q, k] k[k]    dk[k] = sum_q ds[q, k] q[q]    dv[k] = sum_q p[q, k] do[q]
//
// Replaces the TPU kernel spacy_ray_tpu/ops/flash_attention.py::_bwd_kernel
// (launched by _bwd_raw). That kernel keeps a head's whole K/V in VMEM, does
// every product on the MXU in the input type with f32 accumulation (p and
// ds rounded to the input type first), and accumulates dk/dv in its output
// blocks while the grid revisits them query block by query block, in order.
// On the card blocks run in no order and nothing carries over between them,
// so that accumulation cannot be carried over.
//
// Bound on the H100: bytes. q, k, v, o, do read and dq, dk, dv written are
// 16 * B*T*H*Dh bytes in bf16 against, in this design, 14 * B*H*T*T*Dh
// operations (seven products of T*T*Dh): 0.9 * T operations per byte, 112
// at T = 128 against the card's ~295 for bf16 on the tensor cores. The
// products must run on the tensor cores (on the CUDA cores' 67 TFLOP/s of
// f32 they are the bound), and the tiles must arrive while the previous one
// is being multiplied.
//
// Design of the bf16 kernels (the path training takes), deterministic with
// no atomics, two launches on one stream:
//
// 1. Query-major (flash_bwd_dq_bf16): one CTA of 8 warps per (batch, head,
//    128 queries), 16 query rows per warp. It forms delta from the rows' do
//    and o, writes it, then streams 64-key tiles of K, V and the bias:
//    S = Q K^T and dP = dO V^T in mma.sync, p and ds in registers, and
//    dQ += dS(bf16) K with ds rounded in registers as the A operand.
// 2. Key-major (flash_bwd_dkdv_bf16): one CTA of 8 warps per (batch, head,
//    128 keys), 16 keys per warp. It streams 64-query tiles of Q, dO, lse,
//    delta and dlse: S^T = K Q^T and dP^T = V dO^T, then dV += P^T(bf16) dO
//    and dK += dS^T(bf16) Q. Each key's sums are owned by one warp and taken
//    in query order, so dk and dv are the same bits on every run.
//
// Every product has bf16 operands and f32 accumulators (mma.sync m16n8k16,
// fed by ldmatrix, .trans where the tile's rows are the k index); every tile
// arrives by 16-byte cp.async (4-byte for per-row scalars) into padded
// shared tiles, double buffered, so tile j+1 is in flight while tile j is
// multiplied. Pass 1 recomputes S and dP, which pass 2 computes again: seven
// products where one CTA per head holding all of it would need five. That
// single-CTA form fits shared memory only up to T = 128 (Q, K, V, dO and dS
// of a head), and the port also runs T = 130 to 512; the two passes cover
// every T with one code path, and the two extra products stay under the
// bytes bound above.
//
// Both passes are held back by latency more than by bandwidth at T = 128
// (two streamed tiles per CTA). Eight warps share each streamed tile (at
// T = 128 a head's K and V, or Q and dO, are read once per pass); each warp
// works a tile in register tiles of 32 columns, one after the other, and
// the register budget is capped at 128 for 2 CTAs (16 warps) per SM; exp is
// the hardware's ex2 (__expf; exp(0) stays 1 for the rows of -1e30 biases).
// On the H100 each of these choices measured faster than its alternative
// (4 warps, 64-column register tiles, 168 registers, expf).
//
// Key tiles past the row's key extent (one past its last real key) are not
// visited by pass 1, and pass 2 writes zeros for the dk and dv of a CTA
// whose keys are all past it without computing: their bias is -1e30, so
// p = 0 exactly. A row with no real key has extent T: every tile runs and
// p is recomputed from its lse.
//
// f32 inputs take the first design of these kernels, f32 arithmetic on the
// CUDA cores: 4 threads per query (pass 1) or key (pass 2), each owning
// every 4th element of the head dim, 32-row tiles upcast into shared memory.
//
// Rows whose keys are all masked (batch padding) stay finite: the finite
// -1e30 bias makes their scores equal, and p is recomputed from the same lse
// the forward wrote.
#include "common.cuh"
#include "mma.cuh"

namespace {

using srt::bf16;

struct Strides {
  long long q_sb, q_st, k_sb, k_st, v_sb, v_st;
};

__device__ __forceinline__ int key_extent(const int* extent, int b, int T_len) {
  return extent != nullptr ? min(max(extent[b], 1), T_len) : T_len;
}

// ------------------------------------------------ f32: CUDA-core kernels

constexpr int kLanes = 4;     // threads per query (pass 1) or key (pass 2)
constexpr int kRows = 64;     // queries (pass 1) or keys (pass 2) per CTA
constexpr int kRowTile = 32;  // keys (pass 1) or queries (pass 2) per smem tile
constexpr int kThreads = kRows * kLanes;

__device__ __forceinline__ float lane_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 const int* __restrict__ extent, const float* __restrict__ o,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ dlse, float* __restrict__ dq,
                 float* __restrict__ delta, int T_len, int H, Strides st, float scale) {
  constexpr int PER = DH / kLanes;
  __shared__ float ks[kRowTile][DH];
  __shared__ float vs[kRowTile][DH];
  __shared__ float bs[kRowTile];

  const int tid = threadIdx.x;
  const int qi = tid / kLanes;
  const int part = tid % kLanes;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int t = blockIdx.y * kRows + qi;
  const bool active = t < T_len;
  const int tc = active ? t : 0;
  const long long row = (static_cast<long long>(b) * T_len + tc) * H + h;
  const int n_keys = key_extent(extent, b, T_len);

  float qr[PER], dor[PER], acc[PER];
  const float* qp = q + b * st.q_sb + static_cast<long long>(tc) * st.q_st + h * DH;
  const float* op = o + row * DH;
  const float* dop = dout + row * DH;
  float dl = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = part + kLanes * i;
    qr[i] = active ? qp[c] : 0.f;
    dor[i] = active ? dop[c] : 0.f;
    dl = fmaf(dor[i], active ? op[c] : 0.f, dl);
    acc[i] = 0.f;
  }
  const float dlt = lane_sum(dl);
  const float lse_q = active ? lse[row] : 0.f;
  const float dlse_q = (active && dlse != nullptr) ? dlse[row] : 0.f;
  if (active && part == 0) delta[row] = dlt;

  const float* kb = k + b * st.k_sb + h * DH;
  const float* vb = v + b * st.v_sb + h * DH;
  const float* biasb = bias + static_cast<long long>(b) * T_len;

  for (int k0 = 0; k0 < n_keys; k0 += kRowTile) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < kRowTile * DH; idx += kThreads) {
      const int r = idx / DH;
      const int c = idx % DH;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < T_len) {
        kv = kb[key * st.k_st + c];
        vv = vb[key * st.v_st + c];
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    if (tid < kRowTile) bs[tid] = (k0 + tid < T_len) ? biasb[k0 + tid] : 0.f;
    __syncthreads();

    const int nk = min(kRowTile, T_len - k0);
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
    float* dqp = dq + row * DH;
#pragma unroll
    for (int i = 0; i < PER; ++i) dqp[part + kLanes * i] = acc[i];
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ bias,
                   const int* __restrict__ extent, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dlse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, int T_len, int H, Strides st, float scale) {
  constexpr int PER = DH / kLanes;
  __shared__ float qs[kRowTile][DH];
  __shared__ float dos[kRowTile][DH];
  __shared__ float ls[kRowTile];   // lse, per query
  __shared__ float ds_[kRowTile];  // delta, per query
  __shared__ float dls[kRowTile];  // dlse, per query

  const int tid = threadIdx.x;
  const int kj = tid / kLanes;
  const int part = tid % kLanes;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int key = blockIdx.y * kRows + kj;
  const bool active = key < T_len;
  const int kc = active ? key : 0;
  const long long out_row = (static_cast<long long>(b) * T_len + kc) * H + h;

  if (blockIdx.y * kRows >= key_extent(extent, b, T_len)) {
    // every key of the block is past the row's last real key: p = 0 exactly
    if (active) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        dk[out_row * DH + part + kLanes * i] = 0.f;
        dv[out_row * DH + part + kLanes * i] = 0.f;
      }
    }
    return;
  }

  float kr[PER], vr[PER], dka[PER], dva[PER];
  const float* kp = k + b * st.k_sb + static_cast<long long>(kc) * st.k_st + h * DH;
  const float* vp = v + b * st.v_sb + static_cast<long long>(kc) * st.v_st + h * DH;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = part + kLanes * i;
    kr[i] = active ? kp[c] : 0.f;
    vr[i] = active ? vp[c] : 0.f;
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  const float bias_k = active ? bias[static_cast<long long>(b) * T_len + kc] : 0.f;

  const float* qb = q + b * st.q_sb + h * DH;
  const long long row0 = static_cast<long long>(b) * T_len * H + h;  // (b, 0, h)

  for (int q0 = 0; q0 < T_len; q0 += kRowTile) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < kRowTile * DH; idx += kThreads) {
      const int r = idx / DH;
      const int c = idx % DH;
      const int qt = q0 + r;
      float qv = 0.f, dv_ = 0.f;
      if (qt < T_len) {
        qv = qb[qt * st.q_st + c];
        dv_ = dout[(row0 + static_cast<long long>(qt) * H) * DH + c];
      }
      qs[r][c] = qv;
      dos[r][c] = dv_;
    }
    if (tid < kRowTile) {
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

    const int nq = min(kRowTile, T_len - q0);
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
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      dk[out_row * DH + part + kLanes * i] = dka[i];
      dv[out_row * DH + part + kLanes * i] = dva[i];
    }
  }
}

// ------------------------------------------ bf16: tensor-core kernels

constexpr int kTile = 64;        // rows per streamed tile
constexpr int kSub = 32;         // keys (pass 1) or queries (pass 2) per register tile
constexpr int kWarpsPerSM = 16;  // resident warps the register budget must allow (128 a thread)
constexpr int kDqWarps = 8;      // pass 1: 16 query rows per warp
constexpr int kDqRows = 16 * kDqWarps;
constexpr int kDkvWarps = 8;     // pass 2: 16 key rows per warp
constexpr int kDkvRows = 16 * kDkvWarps;

template <int DH>
struct DqSmem {
  bf16 q[kDqRows][DH + 8];
  bf16 dout[kDqRows][DH + 8];
  bf16 k[2][kTile][DH + 8];
  bf16 v[2][kTile][DH + 8];
  float bias[2][kTile];
};

template <int DH>
struct DkvSmem {
  bf16 k[kDkvRows][DH + 8];
  bf16 v[kDkvRows][DH + 8];
  bf16 q[2][kTile][DH + 8];
  bf16 dout[2][kTile][DH + 8];
  float lse[2][kTile];
  float delta[2][kTile];
  float dlse[2][kTile];
};

template <int DH>
__global__ void __launch_bounds__(32 * kDqWarps, kWarpsPerSM / kDqWarps)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ bias,
                  const int* __restrict__ extent, const bf16* __restrict__ o,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ dlse, bf16* __restrict__ dq,
                  float* __restrict__ delta, int T_len, int H, Strides st, float scale) {
  constexpr int STR = DH + 8;
  constexpr int KC = DH / 16;    // k-steps over the head dim
  constexpr int ND = DH / 8;     // n-tiles of the head dim
  constexpr int NS = kSub / 8;   // n-tiles of a register tile of keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem<DH>& sm = *reinterpret_cast<DqSmem<DH>*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  constexpr int kCtaThreads = 32 * kDqWarps;
  const int q0 = blockIdx.y * kDqRows;
  const int t0 = q0 + warp * 16;  // this warp's first query
  const int n_tiles = (key_extent(extent, b, T_len) + kTile - 1) / kTile;
  // rows (b, t, h) of the contiguous [B, T, H, Dh] tensors: row0 + t * H
  const long long row0 = static_cast<long long>(b) * T_len * H + h;
  const long long HD = static_cast<long long>(H) * DH;

  const bf16* kb = k + b * st.k_sb + h * DH;
  const bf16* vb = v + b * st.v_sb + h * DH;
  const float* bb = bias + static_cast<long long>(b) * T_len;
  auto load_kv = [&](int j, int buf) {
    const int k0 = j * kTile;
    const int valid = min(kTile, T_len - k0);
    srt::load_tile<kTile, DH, kCtaThreads>(&sm.k[buf][0][0], kb + k0 * st.k_st, st.k_st, valid,
                                         tid);
    srt::load_tile<kTile, DH, kCtaThreads>(&sm.v[buf][0][0], vb + k0 * st.v_st, st.v_st, valid,
                                         tid);
    if (tid < kTile) srt::cp_async4(&sm.bias[buf][tid], bb + k0 + (tid < valid ? tid : 0),
                                    tid < valid);
  };
  const int n_q = min(kDqRows, T_len - q0);
  srt::load_tile<kDqRows, DH, kCtaThreads>(&sm.q[0][0], q + b * st.q_sb + q0 * st.q_st + h * DH,
                                         st.q_st, n_q, tid);
  srt::load_tile<kDqRows, DH, kCtaThreads>(&sm.dout[0][0], dout + (row0 + q0 * H) * DH, HD, n_q,
                                         tid);
  load_kv(0, 0);
  srt::cp_async_commit();

  // delta of this warp's 16 rows, two lanes per row, from global memory
  // while the first tiles are in flight
  float dlt[2], lse_r[2], dlse_r[2];
  {
    const int r = lane / 2;
    const int t = t0 + r;
    float d = 0.f;
    if (t < T_len) {
      const long long off = (row0 + static_cast<long long>(t) * H) * DH + (lane % 2) * (DH / 2);
#pragma unroll
      for (int c = 0; c < DH / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + off + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(dout + off + c);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d = fmaf(__bfloat162float(de[e]), __bfloat162float(oe[e]), d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (lane % 2 == 0 && t < T_len) delta[row0 + static_cast<long long>(t) * H] = d;
    dlt[0] = __shfl_sync(0xffffffffu, d, 2 * g);
    dlt[1] = __shfl_sync(0xffffffffu, d, 2 * (g + 8));
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int tr = t0 + g + 8 * i;
      const long long row = row0 + static_cast<long long>(tr) * H;
      lse_r[i] = tr < T_len ? lse[row] : 0.f;
      dlse_r[i] = (tr < T_len && dlse != nullptr) ? dlse[row] : 0.f;
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) load_kv(j + 1, buf ^ 1);
    srt::cp_async_commit();
    srt::cp_async_wait<1>();
    __syncthreads();

#pragma unroll 1
    for (int sub = 0; sub < kTile; sub += kSub) {
      // S = Q K^T and dP = dO V^T, 16 rows x 32 keys per warp
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t qa[4], da[4];
        srt::ldsm_x4(qa, &sm.q[warp * 16][kc * 16] + srt::frag_a_offset(lane, STR));
        srt::ldsm_x4(da, &sm.dout[warp * 16][kc * 16] + srt::frag_a_offset(lane, STR));
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t r[4];
          srt::ldsm_x4(r, &sm.k[buf][sub + np * 16][kc * 16] + srt::frag_bn_offset(lane, STR));
          srt::mma_bf16(s[2 * np], qa, r[0], r[1]);
          srt::mma_bf16(s[2 * np + 1], qa, r[2], r[3]);
          srt::ldsm_x4(r, &sm.v[buf][sub + np * 16][kc * 16] + srt::frag_bn_offset(lane, STR));
          srt::mma_bf16(dp[2 * np], da, r[0], r[1]);
          srt::mma_bf16(dp[2 * np + 1], da, r[2], r[3]);
        }
      }

      // p from lse, ds in place of s; keys past T get p = 0
      const int k0 = j * kTile + sub;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n * 8 + c2 + (e & 1);
          const int r = e >> 1;
          const float p = k0 + key < T_len
                              ? __expf(s[n][e] * scale + sm.bias[buf][sub + key] - lse_r[r])
                              : 0.f;
          s[n][e] = p * (dp[n][e] - dlt[r] + dlse_r[r]) * scale;
        }
      }

      // dQ += dS K: dS rounded to bf16 in registers is the A operand
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t a[4];
        srt::c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dd = 0; dd < ND / 2; ++dd) {
          uint32_t r[4];
          srt::ldsm_x4_t(r, &sm.k[buf][sub + kk * 16][dd * 16] + srt::frag_bk_offset(lane, STR));
          srt::mma_bf16(acc[2 * dd], a, r[0], r[1]);
          srt::mma_bf16(acc[2 * dd + 1], a, r[2], r[3]);
        }
      }
    }
    __syncthreads();
  }

  // stage dQ through this warp's own rows of the Q tile
  bf16* stage = &sm.q[warp * 16][0];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * STR + n * 8 + c2) =
        srt::pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * STR + n * 8 + c2) =
        srt::pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  srt::store_rows<16, DH>(dq + (row0 + static_cast<long long>(t0) * H) * DH, HD, stage,
                          T_len - t0, lane);
}

template <int DH>
__global__ void __launch_bounds__(32 * kDkvWarps, kWarpsPerSM / kDkvWarps)
flash_bwd_dkdv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const int* __restrict__ extent, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dlse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int T_len, int H, Strides st, float scale) {
  constexpr int STR = DH + 8;
  constexpr int KC = DH / 16;
  constexpr int ND = DH / 8;
  constexpr int NS = kSub / 8;   // n-tiles of a register tile of queries
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem<DH>& sm = *reinterpret_cast<DkvSmem<DH>*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  constexpr int kCtaThreads = 32 * kDkvWarps;
  const int kb0 = blockIdx.y * kDkvRows;
  const int n_k = min(kDkvRows, T_len - kb0);
  const long long row0 = static_cast<long long>(b) * T_len * H + h;
  const long long HD = static_cast<long long>(H) * DH;
  const long long out0 = (row0 + static_cast<long long>(kb0) * H) * DH;  // key kb0

  if (kb0 >= key_extent(extent, b, T_len)) {
    // every key of the block is past the row's last real key: p = 0 exactly
    constexpr int kChunks = DH / 8;
    for (int c = tid; c < n_k * kChunks; c += kCtaThreads) {
      const long long off = out0 + (c / kChunks) * HD + (c % kChunks) * 8;
      *reinterpret_cast<uint4*>(dk + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(dv + off) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const bf16* qb = q + b * st.q_sb + h * DH;
  auto load_q = [&](int i, int buf) {
    const int q0 = i * kTile;
    const int valid = min(kTile, T_len - q0);
    srt::load_tile<kTile, DH, kCtaThreads>(&sm.q[buf][0][0], qb + q0 * st.q_st, st.q_st, valid,
                                         tid);
    srt::load_tile<kTile, DH, kCtaThreads>(&sm.dout[buf][0][0], dout + (row0 + q0 * H) * DH, HD,
                                         valid, tid);
    if (tid < kTile) {
      const bool ok = tid < valid;
      const long long row = row0 + static_cast<long long>(q0 + (ok ? tid : 0)) * H;
      srt::cp_async4(&sm.lse[buf][tid], lse + row, ok);
      srt::cp_async4(&sm.delta[buf][tid], delta + row, ok);
      srt::cp_async4(&sm.dlse[buf][tid], (dlse != nullptr ? dlse : lse) + row,
                     ok && dlse != nullptr);
    }
  };
  srt::load_tile<kDkvRows, DH, kCtaThreads>(&sm.k[0][0],
                                          k + b * st.k_sb + kb0 * st.k_st + h * DH, st.k_st,
                                          n_k, tid);
  srt::load_tile<kDkvRows, DH, kCtaThreads>(&sm.v[0][0],
                                          v + b * st.v_sb + kb0 * st.v_st + h * DH, st.v_st,
                                          n_k, tid);
  load_q(0, 0);
  srt::cp_async_commit();

  // the biases of this lane's two keys; keys past T get p = 0
  float bias_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kb0 + warp * 16 + g + 8 * i;
    bias_r[i] = key < T_len ? bias[static_cast<long long>(b) * T_len + key] : -INFINITY;
  }

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int n_tiles = (T_len + kTile - 1) / kTile;
  for (int i = 0; i < n_tiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_tiles) load_q(i + 1, buf ^ 1);
    srt::cp_async_commit();
    srt::cp_async_wait<1>();
    __syncthreads();

#pragma unroll 1
    for (int sub = 0; sub < kTile; sub += kSub) {
      // S^T = K Q^T and dP^T = V dO^T, 16 keys x 32 queries per warp
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t ka[4], va[4];
        srt::ldsm_x4(ka, &sm.k[warp * 16][kc * 16] + srt::frag_a_offset(lane, STR));
        srt::ldsm_x4(va, &sm.v[warp * 16][kc * 16] + srt::frag_a_offset(lane, STR));
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t r[4];
          srt::ldsm_x4(r, &sm.q[buf][sub + np * 16][kc * 16] + srt::frag_bn_offset(lane, STR));
          srt::mma_bf16(s[2 * np], ka, r[0], r[1]);
          srt::mma_bf16(s[2 * np + 1], ka, r[2], r[3]);
          srt::ldsm_x4(r, &sm.dout[buf][sub + np * 16][kc * 16] +
                              srt::frag_bn_offset(lane, STR));
          srt::mma_bf16(dp[2 * np], va, r[0], r[1]);
          srt::mma_bf16(dp[2 * np + 1], va, r[2], r[3]);
        }
      }

      // p^T and ds^T in place; queries past T get p = 0
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = sub + n * 8 + c2 + (e & 1);  // within the tile
          const int r = e >> 1;
          const float p = i * kTile + qi < T_len
                              ? __expf(s[n][e] * scale + bias_r[r] - sm.lse[buf][qi])
                              : 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - sm.delta[buf][qi] + sm.dlse[buf][qi]) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q, p and ds rounded to bf16 in registers
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t pa[4], da[4];
        srt::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        srt::c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dd = 0; dd < ND / 2; ++dd) {
          uint32_t r[4];
          srt::ldsm_x4_t(r, &sm.dout[buf][sub + kk * 16][dd * 16] +
                                srt::frag_bk_offset(lane, STR));
          srt::mma_bf16(dva[2 * dd], pa, r[0], r[1]);
          srt::mma_bf16(dva[2 * dd + 1], pa, r[2], r[3]);
          srt::ldsm_x4_t(r, &sm.q[buf][sub + kk * 16][dd * 16] + srt::frag_bk_offset(lane, STR));
          srt::mma_bf16(dka[2 * dd], da, r[0], r[1]);
          srt::mma_bf16(dka[2 * dd + 1], da, r[2], r[3]);
        }
      }
    }
    __syncthreads();
  }

  // stage dK and dV through this warp's own rows of the K and V tiles
  bf16* sk = &sm.k[warp * 16][0];
  bf16* sv = &sm.v[warp * 16][0];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int c0 = g * STR + n * 8 + c2;
    const int c1 = (g + 8) * STR + n * 8 + c2;
    *reinterpret_cast<uint32_t*>(sk + c0) = srt::pack_bf16(dka[n][0], dka[n][1]);
    *reinterpret_cast<uint32_t*>(sk + c1) = srt::pack_bf16(dka[n][2], dka[n][3]);
    *reinterpret_cast<uint32_t*>(sv + c0) = srt::pack_bf16(dva[n][0], dva[n][1]);
    *reinterpret_cast<uint32_t*>(sv + c1) = srt::pack_bf16(dva[n][2], dva[n][3]);
  }
  __syncwarp();
  const long long wo = out0 + warp * 16 * HD;
  srt::store_rows<16, DH>(dk + wo, HD, sk, n_k - warp * 16, lane);
  srt::store_rows<16, DH>(dv + wo, HD, sv, n_k - warp * 16, lane);
}

// shared memory above 48 KB needs the kernel's opt-in, once per process
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const float* bias,
                        const int* extent, const void* o, const void* dout, const float* lse,
                        const float* dlse, void* dq, void* dk, void* dv, float* delta, int B,
                        int T_len, int H, const Strides& st, float scale, cudaStream_t s) {
  constexpr int kDq = sizeof(DqSmem<DH>);
  constexpr int kDkv = sizeof(DkvSmem<DH>);
  static const cudaError_t attr_dq = allow_smem(flash_bwd_dq_bf16<DH>, kDq);
  static const cudaError_t attr_dkdv = allow_smem(flash_bwd_dkdv_bf16<DH>, kDkv);
  if (attr_dq != cudaSuccess) return attr_dq;
  if (attr_dkdv != cudaSuccess) return attr_dkdv;
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* dop = static_cast<const bf16*>(dout);
  const unsigned bh = static_cast<unsigned>(B * H);
  flash_bwd_dq_bf16<DH><<<dim3(bh, (T_len + kDqRows - 1) / kDqRows), 32 * kDqWarps, kDq, s>>>(
      qp, kp, vp, bias, extent, static_cast<const bf16*>(o), dop, lse, dlse,
      static_cast<bf16*>(dq), delta, T_len, H, st, scale);
  flash_bwd_dkdv_bf16<DH><<<dim3(bh, (T_len + kDkvRows - 1) / kDkvRows), 32 * kDkvWarps, kDkv,
                            s>>>(
      qp, kp, vp, bias, extent, dop, lse, dlse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T_len, H, st, scale);
  return cudaSuccess;
}

template <int DH>
void launch_f32(const void* q, const void* k, const void* v, const float* bias,
                const int* extent, const void* o, const void* dout, const float* lse,
                const float* dlse, void* dq, void* dk, void* dv, float* delta, int B, int T_len,
                int H, const Strides& st, float scale, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((T_len + kRows - 1) / kRows));
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* dop = static_cast<const float*>(dout);
  flash_bwd_dq_f32<DH><<<grid, kThreads, 0, s>>>(
      qp, kp, vp, bias, extent, static_cast<const float*>(o), dop, lse, dlse,
      static_cast<float*>(dq), delta, T_len, H, st, scale);
  flash_bwd_dkdv_f32<DH><<<grid, kThreads, 0, s>>>(
      qp, kp, vp, bias, extent, dop, lse, dlse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), T_len, H, st, scale);
}

template <int DH>
cudaError_t launch(int dtype, const void* q, const void* k, const void* v, const void* bias,
                   const void* extent, const void* o, const void* dout, const void* lse,
                   const void* dlse, void* dq, void* dk, void* dv, void* delta, int B,
                   int T_len, int H, const Strides& st, float scale, cudaStream_t s) {
  const auto* bs = static_cast<const float*>(bias);
  const auto* ext = static_cast<const int*>(extent);
  const auto* ls = static_cast<const float*>(lse);
  const auto* dls = static_cast<const float*>(dlse);
  auto* dl = static_cast<float*>(delta);
  if (dtype == 1)
    return launch_bf16<DH>(q, k, v, bs, ext, o, dout, ls, dls, dq, dk, dv, dl, B, T_len, H, st,
                           scale, s);
  launch_f32<DH>(q, k, v, bs, ext, o, dout, ls, dls, dq, dk, dv, dl, B, T_len, H, st, scale, s);
  return cudaSuccess;
}

}  // namespace

// q/k/v [B, T, H, Dh] with (batch, time) element strides given, heads and the
// head dim contiguous (bf16: 16-byte aligned rows); bias [B, T] f32; extent
// [B] int32 (keys >= extent[b] have the -1e30 bias) or null for T; o, dout,
// dq, dk, dv [B, T, H, Dh] contiguous in the input type; lse, delta
// [B, T, H] f32 (delta is written by the first pass and read by the second);
// dlse [B, T, H] f32 or null for a zero lse cotangent.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int srt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* bias, const void* extent,
    const void* o, const void* dout, const void* lse, const void* dlse, void* dq, void* dk,
    void* dv, void* delta, int B, int T_len, int H, int dh, long long q_sb, long long q_st,
    long long k_sb, long long k_st, long long v_sb, long long v_st, float scale, int dtype,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || T_len == 0 || H == 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_st, k_sb, k_st, v_sb, v_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      err = launch<16>(dtype, q, k, v, bias, extent, o, dout, lse, dlse, dq, dk, dv, delta, B,
                       T_len, H, st, scale, s);
      break;
    case 64:
      err = launch<64>(dtype, q, k, v, bias, extent, o, dout, lse, dlse, dq, dk, dv, delta, B,
                       T_len, H, st, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
