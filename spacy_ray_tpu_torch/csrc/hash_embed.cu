// HashEmbed gather-sum: out[n, :] = table[ids[n,0]] + table[ids[n,1]]
//                                   + table[ids[n,2]] + table[ids[n,3]]
//
// Replaces the TPU kernel spacy_ray_tpu/ops/pallas_kernels.py::_kernel
// (launched by _pallas_lookup_raw). That kernel keeps the whole table in
// VMEM, which caps it at 8 MB of table; the port runs for every table size.
//
// Bound on the H100: bytes. A call reads each distinct table row it names
// once and writes N rows, with no arithmetic to speak of. The 61 MB NORM
// table of the transformer config does not fit the 50 MB L2, so the rows
// come from HBM when the trunk has flushed L2 since the last call.
//
// Design: a call is two dependent trips to memory (the ids, then the rows),
// so it is latency-bound unless the whole call is in flight at once. Each
// thread owns one output float4 of one token: lane l of a warp takes column
// c = 32 * blockIdx.y + l (16-byte words; neighbouring lanes on neighbouring
// words, so each row load of a warp is one coalesced 512-byte request), and
// warp w of the CTA takes token blockIdx.x * kWarps + w. A thread loads the
// token's ids quadruple (every lane of the warp names the same 16 bytes, so
// it is one request broadcast to the 32 lanes), then its four row words, then
// adds them left to right as the TPU kernel does. No loop over the row: at N
// 1024 and D 768 the 1536 CTAs of 4 warps fit the 132 SMs at once (46 warps
// on each), and N 1 still launches 6 small CTAs. Nothing is staged in shared
// memory: nothing is reused across threads. The output is stored plainly, so
// that the layer reading it next finds it in L2; two tokens a warp and
// evict-first stores measured no faster (PERF.md).
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
gather_sum(const float4* __restrict__ table, const int4* __restrict__ ids,
           float4* __restrict__ out, long long n, int d4) {
  const int c = blockIdx.y * 32 + threadIdx.x;
  const long long t = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.y;
  if (c >= d4 || t >= n) return;
  const int4 r = __ldg(ids + t);
  const float4 a = __ldg(table + static_cast<long long>(r.x) * d4 + c);
  const float4 b = __ldg(table + static_cast<long long>(r.y) * d4 + c);
  const float4 e = __ldg(table + static_cast<long long>(r.z) * d4 + c);
  const float4 f = __ldg(table + static_cast<long long>(r.w) * d4 + c);
  float4 s;
  s.x = ((a.x + b.x) + e.x) + f.x;
  s.y = ((a.y + b.y) + e.y) + f.y;
  s.z = ((a.z + b.z) + e.z) + f.z;
  s.w = ((a.w + b.w) + e.w) + f.w;
  out[t * d4 + c] = s;
}

}  // namespace

// table [rows, d] f32, ids [n, 4] int32, out [n, d] f32; all contiguous,
// 16-byte aligned, d a multiple of 4 (the wrapper checks all of it).
extern "C" int srt_hash_embed_gather_sum(const void* table, const void* ids, void* out,
                                         long long n, int d, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d % 4 != 0 || (d / 4 + 31) / 32 > 65535 || n / kWarps >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || d == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n + kWarps - 1) / kWarps),
                  static_cast<unsigned>((d / 4 + 31) / 32));
  gather_sum<<<grid, dim3(32, kWarps), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), static_cast<const int4*>(ids),
      static_cast<float4*>(out), n, d / 4);
  return static_cast<int>(cudaGetLastError());
}
