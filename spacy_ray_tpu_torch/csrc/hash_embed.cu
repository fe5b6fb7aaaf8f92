// HashEmbed gather-sum: out[n, :] = table[ids[n,0]] + table[ids[n,1]]
//                                   + table[ids[n,2]] + table[ids[n,3]]
//
// Replaces the TPU kernel spacy_ray_tpu/ops/pallas_kernels.py::_kernel
// (launched by _pallas_lookup_raw). That kernel keeps the whole table in
// VMEM, which caps it at 8 MB of table; the port runs for every table size.
//
// Bound on the H100: bytes. Each token reads four table rows and writes one
// row, N * (4*D*4 + D*4 + 16) bytes, with no arithmetic to speak of. The
// 61 MB NORM table of the transformer config does not fit the 50 MB L2, so
// the rows come from HBM when the trunk has flushed L2 since the last call.
//
// Design: one warp per token row. The four row indices are one 16-byte load;
// each lane then walks the row in float4 steps (neighbouring lanes on
// neighbouring 16-byte words, so each warp-wide load is one coalesced 512-byte
// request per row) and sums the four rows in registers, left to right as the
// TPU kernel does. There is no staging in shared memory: nothing is reused
// within a row, and the ids need no padding of N to a block multiple.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_sum_vec4(const float4* __restrict__ table, const int4* __restrict__ ids,
                float4* __restrict__ out, long long n, int d4) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const int4 r = __ldg(ids + row);
  const float4* t0 = table + static_cast<long long>(r.x) * d4;
  const float4* t1 = table + static_cast<long long>(r.y) * d4;
  const float4* t2 = table + static_cast<long long>(r.z) * d4;
  const float4* t3 = table + static_cast<long long>(r.w) * d4;
  float4* o = out + row * d4;
  for (int c = lane; c < d4; c += 32) {
    const float4 a = __ldg(t0 + c);
    const float4 b = __ldg(t1 + c);
    const float4 e = __ldg(t2 + c);
    const float4 f = __ldg(t3 + c);
    float4 s;
    s.x = ((a.x + b.x) + e.x) + f.x;
    s.y = ((a.y + b.y) + e.y) + f.y;
    s.z = ((a.z + b.z) + e.z) + f.z;
    s.w = ((a.w + b.w) + e.w) + f.w;
    o[c] = s;
  }
}

}  // namespace

// table [rows, d] f32, ids [n, 4] int32, out [n, d] f32; all contiguous,
// 16-byte aligned, d a multiple of 4 (the wrapper checks all of it).
extern "C" int srt_hash_embed_gather_sum(const void* table, const void* ids,
                                         void* out, long long n, int d,
                                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || d == 0) return 0;
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock));
  gather_sum_vec4<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int4*>(ids),
      static_cast<float4*>(out), n, d / 4);
  return static_cast<int>(cudaGetLastError());
}
