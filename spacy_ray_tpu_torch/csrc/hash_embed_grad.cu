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
// The order of summation, shared with the plain version
// (ops/pallas_kernels.py::hash_embed_table_grad_plain): the wrapper sorts
// the 4N (row, token*4 + j) pairs by row with a stable sort (preparation,
// not summation; on int16 keys where the table has at most 2^15 rows, which
// halves the radix passes) and the sorted array is cut into chunks of C
// consecutive pairs, C being the wrapper's TABLE_GRAD_CHUNK, passed to both
// launches. A row's pairs fall in one or more chunks; each piece
// (row and chunk) is summed from zero in ascending (token, j) order, and the
// row is the sum of its pieces, from zero, in chunk order. A row within one
// chunk is therefore its pairs summed in order from zero. No float atomics:
// runs are bit-identical, and bit-equal to the plain version on the CPU.
//
// Why chunks: the ids are as skewed as the data. Every batch-padding token
// hashes the zero key to the same rows (17,400 pairs of a training
// microbatch land on one row), so one CTA per row (the first design) left
// one SM streaming ~53 MB of cotangents while the others idled. Here the
// work of a CTA in pass 1 is C pairs whatever the skew, and a long row
// costs pass 2 only its pieces (one per chunk), 1/C of its pairs.
//
// Pass 1 (table_grad_pieces): one CTA per chunk, each thread one float4
// column (16-byte loads of the 768-wide cotangent rows; loads run kUnroll
// pairs ahead of the ordered adds). A run of equal rows that begins and
// ends inside the chunk is a whole row and goes straight to dtable; a run
// that continues the previous chunk's row goes to carry[chunk][0], one that
// continues into the next chunk (and not from the previous) to
// carry[chunk][1]. The same launch writes the zeros: CTAs after the chunks'
// each own kRowsPerCta rows, find which of them no id names by binary
// search in the sorted rows (no offsets array, no separate zero fill) and
// write those, so the zero rows' stores overlap the chunks' loads.
// Pass 2 (table_grad_spans): the CTAs of chunks 1..n-1 each check whether a
// row continues into their chunk from the previous one and ends in it; if
// so they write it, a thread per column: carry[c0][1] + carry[c0+1][0] +
// ... + carry[c1][0] in that order, kAhead carries in flight ahead of the
// ordered adds. Every other CTA returns at once.
//
#include "common.cuh"

namespace {

constexpr int kMaxChunk = 4096;  // C's ceiling: 2 * C ints of dynamic shared memory
constexpr int kUnroll = 8;       // cotangent rows in flight per thread in pass 1
constexpr int kRowsPerCta = 64;  // table rows per zero-writing CTA of pass 1
constexpr int kAhead = 32;       // carries in flight per thread in pass 2
constexpr int kSpanThreads = 256;  // columns per CTA in pass 2, one float each

__device__ __forceinline__ void add4(float4& a, const float4& x) {
  a.x += x.x;
  a.y += x.y;
  a.z += x.z;
  a.w += x.w;
}

// the first of the sorted pairs [0, n) whose row is >= key
template <typename KT>
__device__ __forceinline__ int first_at_least(const KT* __restrict__ row_of, int n,
                                              long long key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = static_cast<int>((static_cast<long long>(lo) + hi) >> 1);
    if (__ldg(row_of + mid) < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Pass 1. CTAs [0, n_chunks) sum the pieces of one chunk of chunk_pairs (C)
// pairs each; the CTAs after them write zeros to the rows no id names,
// kRowsPerCta rows each. Dynamic shared memory: 2 * chunk_pairs ints.
template <typename KT>
__global__ void __launch_bounds__(256)
table_grad_pieces(const float4* __restrict__ ct, const KT* __restrict__ row_of,
                  const long long* __restrict__ order, int n_pairs, int chunk_pairs,
                  int n_chunks, long long rows, float4* __restrict__ dtable,
                  float4* __restrict__ carry, int d4) {
  extern __shared__ int spairs[];
  int* srow = spairs;                // the chunk's sorted rows
  int* stok = spairs + chunk_pairs;  // and the token of each pair
  __shared__ int bound[kRowsPerCta + 1];  // row r0 + i is sorted pairs [bound[i], bound[i+1])
  __shared__ bool edge[2];  // the chunk's first row continues the previous chunk; its last the next
  const int tid = threadIdx.x;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (static_cast<int>(blockIdx.x) >= n_chunks) {
    const long long r0 = static_cast<long long>(blockIdx.x - n_chunks) * kRowsPerCta;
    for (int t = tid; t <= kRowsPerCta; t += blockDim.x)
      bound[t] = first_at_least(row_of, n_pairs, r0 + t);
    __syncthreads();
    const int nr = static_cast<int>(min(static_cast<long long>(kRowsPerCta), rows - r0));
    for (int e = tid; e < nr * d4; e += blockDim.x) {  // 16-byte stores over every thread
      const int i = e / d4;
      if (bound[i] == bound[i + 1]) dtable[(r0 + i) * d4 + e % d4] = zero;
    }
    return;
  }
  const int chunk = blockIdx.x;
  const int beg = chunk * chunk_pairs;
  const int n = min(chunk_pairs, n_pairs - beg);
  for (int k = tid; k < n; k += blockDim.x) {  // a narrow table has fewer threads than C
    srow[k] = __ldg(row_of + beg + k);
    stok[k] = static_cast<int>(__ldg(order + beg + k) >> 2);  // pair = token*4 + j
  }
  if (tid == 0) edge[0] = beg > 0 && __ldg(row_of + beg - 1) == __ldg(row_of + beg);
  if (tid == 1)
    edge[1] = beg + n < n_pairs && __ldg(row_of + beg + n) == __ldg(row_of + beg + n - 1);
  __syncthreads();
  float4* carry_first = carry + (2LL * chunk) * d4;
  float4* carry_last = carry_first + d4;
  for (int c = tid; c < d4; c += blockDim.x) {
    float4 acc = zero;
    bool from_prev = edge[0];  // the run being summed continues the previous chunk's row
    for (int k0 = 0; k0 < n; k0 += kUnroll) {
      float4 x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        x[u] = k0 + u < n ? __ldg(ct + static_cast<long long>(stok[k0 + u]) * d4 + c) : zero;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // in order: the loads only run ahead
        const int k = k0 + u;
        if (k >= n) break;
        add4(acc, x[u]);
        if (k == n - 1 || srow[k] != srow[k + 1]) {  // the run of row srow[k] ends at k
          const long long row = srow[k];
          const bool to_next = k == n - 1 && edge[1];
          if (from_prev) {
            carry_first[c] = acc;
          } else if (to_next) {
            carry_last[c] = acc;
          } else if (row >= 0 && row < rows) {
            dtable[row * d4 + c] = acc;
          }
          acc = zero;
          from_prev = false;
        }
      }
    }
  }
}

// Pass 2. The CTA of chunk blockIdx.x + 1 finishes the row that continues
// from the previous chunk and ends in this one, if there is such a row.
template <typename KT>
__global__ void __launch_bounds__(kSpanThreads)
table_grad_spans(const KT* __restrict__ row_of, int n_pairs, int chunk_pairs,
                 const float* __restrict__ carry, float* __restrict__ dtable, long long rows,
                 int d) {
  const int c1 = blockIdx.x + 1;
  const int beg = c1 * chunk_pairs;
  const int end = min(beg + chunk_pairs, n_pairs);
  const long long row = __ldg(row_of + beg);
  if (__ldg(row_of + beg - 1) != row) return;  // no row continues into this chunk
  if (end < n_pairs && __ldg(row_of + end) == row) return;  // it goes on past this chunk
  const int c = blockIdx.y * kSpanThreads + threadIdx.x;  // this thread's column
  if (row < 0 || row >= rows || c >= d) return;
  const int c0 = first_at_least(row_of, beg, row) / chunk_pairs;  // the chunk of its first pair
  // its pieces in chunk order, the loads kAhead ahead of the adds
  float acc = 0.f;
  acc += carry[(2LL * c0 + 1) * d + c];
  int ch = c0 + 1;
  for (; ch + kAhead <= c1 + 1; ch += kAhead) {
    float x[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) x[u] = carry[(2LL * (ch + u)) * d + c];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) acc += x[u];
  }
  for (; ch <= c1; ++ch) acc += carry[(2LL * ch) * d + c];
  dtable[row * d + c] = acc;
}

template <typename KT>
void launch(const KT* row_of, const void* ct, const void* order, void* carry, void* dtable,
            int n_pairs, long long rows, int d, int chunk, cudaStream_t s) {
  const int d4 = d / 4;
  const int threads = d4 >= 256 ? 256 : ((d4 + 31) / 32) * 32;  // one float4 column each
  const int chunks = (n_pairs + chunk - 1) / chunk;
  const long long zero_ctas = (rows + kRowsPerCta - 1) / kRowsPerCta;
  table_grad_pieces<KT><<<static_cast<unsigned>(chunks + zero_ctas), threads,
                          2 * chunk * sizeof(int), s>>>(
      static_cast<const float4*>(ct), row_of, static_cast<const long long*>(order), n_pairs,
      chunk, chunks, rows, static_cast<float4*>(dtable), static_cast<float4*>(carry), d4);
  if (chunks > 1) {
    const dim3 grid(static_cast<unsigned>(chunks - 1),
                    static_cast<unsigned>((d + kSpanThreads - 1) / kSpanThreads));
    table_grad_spans<KT><<<grid, kSpanThreads, 0, s>>>(
        row_of, n_pairs, chunk, static_cast<const float*>(carry), static_cast<float*>(dtable),
        rows, d);
  }
}

}  // namespace

// ct [n, d] f32; row_of [n_pairs] int16 (key_bytes 2) or int32 (4), the
// rows of the flattened ids sorted (stably), all in [0, rows); order
// [n_pairs] int64, the flattened (token*4 + j) pair index of each sorted
// entry; carry [ceil(n_pairs / chunk), 2, d] f32 scratch; dtable [rows, d]
// f32, every row written. All contiguous and 16-byte aligned, d a multiple
// of 4 (the wrapper checks). `chunk` is C, the sorted pairs per chunk of the
// order of summation.
extern "C" int srt_hash_embed_table_grad(const void* ct, const void* row_of, const void* order,
                                         void* carry, void* dtable, int n_pairs,
                                         long long rows, int d, int chunk, int key_bytes,
                                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d % 4 != 0 || chunk < 1 || chunk > kMaxChunk || n_pairs < 0 ||
      (key_bytes != 2 && key_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || d == 0) return 0;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_bytes == 2)
    launch(static_cast<const int16_t*>(row_of), ct, order, carry, dtable, n_pairs, rows, d,
           chunk, s);
  else
    launch(static_cast<const int*>(row_of), ct, order, carry, dtable, n_pairs, rows, d, chunk,
           s);
  return static_cast<int>(cudaGetLastError());
}
