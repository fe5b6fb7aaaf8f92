// Flash attention forward with an additive key-padding bias.
//
//   s[q, k] = (q . k) * scale + bias[b, k]
//   o[q]    = sum_k softmax_k(s[q, :]) v[k]        lse[q] = logsumexp_k s[q, :]
//
// Replaces the TPU kernel spacy_ray_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _fwd_raw). That kernel holds a whole head's K/V in VMEM, pads
// the head dim to 128 lanes and the sequence to 128 rows, forms one [128, T]
// score block on the MXU in the input type with f32 accumulation, rounds the
// unnormalised p to the input type for the second product and divides by
// the f32 row sum. Here q/k/v stay in the trunk's [B, T, H, Dh] layout (any
// batch/time strides, heads and head dim contiguous), Dh is the real head
// dim, and keys stream through shared memory in 64-key tiles with an online
// softmax, so nothing is padded and no score reaches device memory.
//
// Bound on the H100: bytes. q, k, v read and o written are 8 * B*T*H*Dh
// bytes in bf16 against 4 * B*H*T*T*Dh operations, 0.5 * T operations per
// byte: 64 at T = 128 and 256 at T = 512, both under the card's ~295 for
// bf16 on the tensor cores (at T = 128 the bytes take ~4.5 x the time of
// the operations). The operations must therefore run on the tensor cores
// (67 TFLOP/s in f32 on the CUDA cores would make them the bound) and the
// tiles must arrive while the previous one is being multiplied.
//
// Design of the bf16 kernel (the path serving and training take):
// - One CTA of 8 warps per (batch, head, 128 queries); each warp owns 16
//   query rows (the FlashAttention-2 split), so the softmax statistics of a
//   row never leave one quad of lanes, and the 8 warps share each K/V tile
//   (at T = 128 a head's K and V are read once).
// - Q, then each 64-key tile of K and V and its 64 biases, arrive by 16-byte
//   cp.async (4-byte for the biases) into padded shared tiles, double
//   buffered: tile j+1 is in flight while tile j is multiplied.
// - S = Q K^T and O += P V are mma.sync m16n8k16 with bf16 operands and f32
//   accumulators, fed by ldmatrix (.trans for V). S stays in registers;
//   scale, bias, the row max (two quad shuffles) and exp run there; P is
//   rounded to bf16 in registers and is the A operand of P V directly.
//   O is normalised by the f32 row sum of the unrounded p, as the TPU
//   kernel does, then staged through shared memory for 16-byte stores.
// - Latency, not bandwidth, holds a CTA back at these sizes (two key tiles
//   at T = 128), so the register budget is capped at 128 for 2 CTAs (16
//   warps) per SM, and exp is the hardware's ex2 (__expf): the row max and
//   lse stay exact, so a row of -1e30 biases still gets p = exp(0) = 1.
//   On the H100 8 warps measured faster than 4 at every shape the port
//   runs (B 8 and B 64 at T 128, B 2 at T 512), and __expf than expf.
// - Key tiles past the row's key extent (one past its last real key,
//   computed once per trunk forward) are not visited: their bias is -1e30,
//   so p = exp(-1e30 - m) = 0 exactly for a row with a real key. A row with
//   no real key has extent T and keeps the uniform average below.
//
// f32 inputs take the first design of this kernel, f32 arithmetic on the
// CUDA cores: one CTA per (batch, head, 64 queries), 4 threads per query
// each owning every 4th element of the head dim, 32-key tiles upcast into
// shared memory. TF32 would break the f32 path's tolerance.
//
// Batch-padding rows have every key masked. With the finite -1e30 bias
// (never -inf) their scores are all equal, so they get a finite uniform
// average instead of 0/0: a NaN there would survive the trunk's final
// multiply by the mask.
#include "common.cuh"
#include "mma.cuh"

namespace {

using srt::bf16;

// ------------------------------------------------ f32: CUDA-core kernel

constexpr int kBQ = 64;      // queries per CTA
constexpr int kBK = 32;      // keys per shared-memory tile
constexpr int kLanes = 4;    // threads per query
constexpr int kThreads = kBQ * kLanes;

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              const int* __restrict__ extent, float* __restrict__ o, float* __restrict__ lse,
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
  const int n_keys = extent != nullptr ? min(max(extent[b], 1), T_len) : T_len;

  float qr[PER];
  float acc[PER];
  const float* qp = q + b * q_sb + static_cast<long long>(active ? t : 0) * q_st + h * DH;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    qr[i] = active ? qp[part + kLanes * i] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  const float* kb = k + b * k_sb + h * DH;
  const float* vb = v + b * v_sb + h * DH;
  const float* biasb = bias + static_cast<long long>(b) * T_len;

  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < kBK * DH; idx += kThreads) {
      const int r = idx / DH;
      const int c = idx % DH;
      const int key = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (key < T_len) {
        kv = kb[key * k_st + c];
        vv = vb[key * v_st + c];
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
    float* op = o + row * DH;
    const float inv = 1.f / l;
#pragma unroll
    for (int i = 0; i < PER; ++i) op[part + kLanes * i] = acc[i] * inv;
    if (part == 0) lse[row] = m + logf(l);
  }
}

// ------------------------------------------- bf16: tensor-core kernel

constexpr int kTile = 64;              // keys per tile
constexpr int kWarps = 8;              // warps of 16 query rows
constexpr int kQRows = 16 * kWarps;    // queries per CTA
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kMinBlocks = 2;          // CTAs per SM: at most 128 registers a thread

template <int DH>
struct FwdSmem {
  bf16 q[kQRows][DH + 8];
  bf16 k[2][kTile][DH + 8];
  bf16 v[2][kTile][DH + 8];
  float bias[2][kTile];
};

template <int DH>
__global__ void __launch_bounds__(kMmaThreads, kMinBlocks)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ bias,
               const int* __restrict__ extent, bf16* __restrict__ o, float* __restrict__ lse,
               int T_len, int H, long long q_sb, long long q_st, long long k_sb,
               long long k_st, long long v_sb, long long v_st, float scale) {
  constexpr int STR = DH + 8;   // shared row stride, elements
  constexpr int KC = DH / 16;   // k-steps over the head dim
  constexpr int ND = DH / 8;    // n-tiles of the head dim
  constexpr int NK = kTile / 8; // n-tiles of a key tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem<DH>& sm = *reinterpret_cast<FwdSmem<DH>*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;       // fragment row (and row + 8)
  const int c2 = 2 * (lane % 4);  // fragment column pair
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int q0 = blockIdx.y * kQRows;
  const int n_keys = extent != nullptr ? min(max(extent[b], 1), T_len) : T_len;
  const int n_tiles = (n_keys + kTile - 1) / kTile;

  const bf16* kb = k + b * k_sb + h * DH;
  const bf16* vb = v + b * v_sb + h * DH;
  const float* bb = bias + static_cast<long long>(b) * T_len;

  auto load_kv = [&](int j, int buf) {
    const int k0 = j * kTile;
    const int valid = min(kTile, T_len - k0);
    srt::load_tile<kTile, DH, kMmaThreads>(&sm.k[buf][0][0], kb + k0 * k_st, k_st, valid, tid);
    srt::load_tile<kTile, DH, kMmaThreads>(&sm.v[buf][0][0], vb + k0 * v_st, v_st, valid, tid);
    if (tid < kTile) srt::cp_async4(&sm.bias[buf][tid], bb + k0 + (tid < valid ? tid : 0),
                                    tid < valid);
  };
  srt::load_tile<kQRows, DH, kMmaThreads>(&sm.q[0][0], q + b * q_sb + q0 * q_st + h * DH,
                                          q_st, min(kQRows, T_len - q0), tid);
  load_kv(0, 0);
  srt::cp_async_commit();

  uint32_t qa[KC][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this lane's part of the row sums

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) load_kv(j + 1, buf ^ 1);
    srt::cp_async_commit();
    srt::cp_async_wait<1>();  // tile j (and Q) have landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        srt::ldsm_x4(qa[kc], &sm.q[warp * 16][kc * 16] + srt::frag_a_offset(lane, STR));
    }

    // S = Q K^T, 16 rows x 64 keys per warp
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t r[4];
        srt::ldsm_x4(r, &sm.k[buf][np * 16][kc * 16] + srt::frag_bn_offset(lane, STR));
        srt::mma_bf16(s[2 * np], qa[kc], r[0], r[1]);
        srt::mma_bf16(s[2 * np + 1], qa[kc], r[2], r[3]);
      }
    }

    // scale and bias, keys past T out; online softmax of rows g and g + 8
    const int k0 = j * kTile;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = n * 8 + c2 + (e & 1);
        const float x = k0 + key < T_len ? s[n][e] * scale + sm.bias[buf][key] : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);  // finite: key k0 < T is in this tile
      const float alpha = __expf(m[r] - m_new);  // 0 on the first tile (m = -inf)
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[n][e] - m[e >> 1]);
        l[e >> 1] += p;
        s[n][e] = p;
      }
    }

    // O += P V: P rounded to bf16 in registers is the A operand
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t pa[4];
      srt::c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t r[4];
        srt::ldsm_x4_t(r, &sm.v[buf][kk * 16][dp * 16] + srt::frag_bk_offset(lane, STR));
        srt::mma_bf16(acc[2 * dp], pa, r[0], r[1]);
        srt::mma_bf16(acc[2 * dp + 1], pa, r[2], r[3]);
      }
    }
    __syncthreads();  // buffer `buf` is refilled by the next iteration's prefetch
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // stage O through this warp's own rows of the Q tile (only this warp
  // read them), then 16-byte stores of whole rows
  bf16* stage = &sm.q[warp * 16][0];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(stage + g * STR + n * 8 + c2) =
        srt::pack_bf16(acc[n][0] / l[0], acc[n][1] / l[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * STR + n * 8 + c2) =
        srt::pack_bf16(acc[n][2] / l[1], acc[n][3] / l[1]);
  }
  __syncwarp();
  const int t0 = q0 + warp * 16;
  const long long row0 = (static_cast<long long>(b) * T_len + t0) * H + h;
  srt::store_rows<16, DH>(o + row0 * DH, static_cast<long long>(H) * DH, stage, T_len - t0,
                          lane);
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (t0 + g + 8 * r < T_len) lse[row0 + (g + 8 * r) * H] = m[r] + logf(l[r]);
  }
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const float* bias,
                        const int* extent, void* o, void* lse, int B, int T_len, int H,
                        const long long* st, float scale, cudaStream_t s) {
  // shared memory above 48 KB needs the kernel's opt-in, once per process
  constexpr int kSmem = sizeof(FwdSmem<DH>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_bf16<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(static_cast<unsigned>(B * H),
                  static_cast<unsigned>((T_len + kQRows - 1) / kQRows));
  flash_fwd_bf16<DH><<<grid, kMmaThreads, kSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, extent, static_cast<bf16*>(o), static_cast<float*>(lse), T_len, H, st[0], st[1],
      st[2], st[3], st[4], st[5], scale);
  return cudaSuccess;
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias,
                   const void* extent, void* o, void* lse, int B, int T_len, int H,
                   const long long* st, float scale, int dtype, cudaStream_t s) {
  const auto* ext = static_cast<const int*>(extent);
  const auto* bs = static_cast<const float*>(bias);
  if (dtype == 0) {
    const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((T_len + kBQ - 1) / kBQ));
    flash_fwd_f32<DH><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bs, ext, static_cast<float*>(o),
        static_cast<float*>(lse), T_len, H, st[0], st[1], st[2], st[3], st[4], st[5], scale);
  } else {
    return launch_bf16<DH>(q, k, v, bs, ext, o, lse, B, T_len, H, st, scale, s);
  }
  return cudaSuccess;
}

}  // namespace

// q/k/v [B, T, H, Dh] with (batch, time) element strides given, heads and the
// head dim contiguous (bf16: 16-byte aligned rows); bias [B, T] f32; extent
// [B] int32 (keys >= extent[b] have the -1e30 bias) or null for T; o
// [B, T, H, Dh] contiguous in the input type; lse [B, T, H] f32.
// dtype: 0 = float32, 1 = bfloat16.
extern "C" int srt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, const void* extent,
    void* o, void* lse, int B, int T_len, int H, int dh, long long q_sb, long long q_st,
    long long k_sb, long long k_st, long long v_sb, long long v_st, float scale, int dtype,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || T_len == 0 || H == 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long st[6] = {q_sb, q_st, k_sb, k_st, v_sb, v_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      err = launch<16>(q, k, v, bias, extent, o, lse, B, T_len, H, st, scale, dtype, s);
      break;
    case 64:
      err = launch<64>(q, k, v, bias, extent, o, lse, B, T_len, H, st, scale, dtype, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
