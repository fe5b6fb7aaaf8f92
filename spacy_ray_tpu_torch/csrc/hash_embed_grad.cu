// HashEmbed table gradient, the backward of the gather-sum:
//
//   dtable[r, :] = sum over (n, j) with ids[n, j] == r of ct[n, :]
//
// Replaces spacy_ray_tpu/ops/pallas_kernels.py::_table_grad, the jnp
// scatter-add inside the hash-embed kernel's custom_vjp (XLA writes zeros,
// then scatter-adds). On the card a scatter-add with f32 atomicAdd sums each
// row in whatever order the atomics land, so the gradient changes from run
// to run in its last bits.
//
// Bound on the H100: bytes. Every row of the table is written once and every
// cotangent row read once, rows*D*4 + N*D*4 bytes plus the ids; there is no
// arithmetic to speak of. For the 20000 x 768 NORM table that is 61 MB of
// writes, so the write of the dense gradient dominates.
//
// Design, deterministic and without atomics: the wrapper orders the N*4
// (row, token*4 + j) pairs by row with a stable sort and finds each row's
// segment (preparation, not summation). Here one CTA owns one table row and
// writes all of it, each thread one float4 column: it walks the row's
// segment in ascending (token, j) order and sums the cotangents in f32. A
// row no id names has an empty segment and gets zeros, so no separate zero
// fill runs. The order is that of the plain version (index_add_ over the
// flattened ids on the CPU), which makes the two bit-equal.
//
// The segments are as skewed as the data: every batch-padding token hashes
// to the same four rows, and a frequent word's rows collect thousands of
// pairs. Splitting a row's columns over a whole CTA (instead of one warp)
// and loading eight cotangent rows ahead of the ordered adds keeps a long
// segment from serialising the launch, without changing the order of any
// element's sum.
#include "common.cuh"

namespace {

constexpr int kUnroll = 8;  // cotangent rows in flight per thread

__global__ void __launch_bounds__(256)
table_grad_vec4(const float4* __restrict__ ct, const int* __restrict__ order,
                const int* __restrict__ offsets, float4* __restrict__ dtable, int d4) {
  const long long row = blockIdx.x;
  const int beg = __ldg(offsets + row);
  const int end = __ldg(offsets + row + 1);
  float4* out = dtable + row * d4;
  for (int c = threadIdx.x; c < d4; c += blockDim.x) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    int k = beg;
    for (; k + kUnroll <= end; k += kUnroll) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long token = __ldg(order + k + u) >> 2;  // pair = token*4 + j
        x[u] = __ldg(ct + token * d4 + c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // in order: the loads only run ahead
        acc.x += x[u].x;
        acc.y += x[u].y;
        acc.z += x[u].z;
        acc.w += x[u].w;
      }
    }
    for (; k < end; ++k) {
      const float4 x = __ldg(ct + (static_cast<long long>(__ldg(order + k)) >> 2) * d4 + c);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    out[c] = acc;
  }
}

}  // namespace

// ct [n, d] f32; order [n*4] int32, the flattened (token*4 + j) pair indices
// stably sorted by their row; offsets [rows + 1] int32, row r's segment of
// order being [offsets[r], offsets[r+1]); dtable [rows, d] f32. All
// contiguous and 16-byte aligned, d a multiple of 4 (the wrapper checks).
extern "C" int srt_hash_embed_table_grad(const void* ct, const void* order,
                                         const void* offsets, void* dtable,
                                         long long rows, int d, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || d == 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int d4 = d / 4;
  const int threads = d4 >= 256 ? 256 : ((d4 + 31) / 32) * 32;  // one column each
  table_grad_vec4<<<static_cast<unsigned>(rows), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(ct), static_cast<const int*>(order),
      static_cast<const int*>(offsets), static_cast<float4*>(dtable), d4);
  return static_cast<int>(cudaGetLastError());
}
