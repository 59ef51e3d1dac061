// K2: event-row compaction of a raw stream fill, one CTA per chain.
//
// Replaces pdmpflux_tpu/ops/pallas/compact.py:compact_field (the Pallas
// log-shift kernel, d >= 128) and the XLA formulations it stands beside
// (core/engine.py: compact_stream_rows, compact_stream_rows_with_init,
// merge_stream_at_offsets).  The plain PyTorch version is compact_rows_plain
// in ops/cuda/compact.py.
//
// For chain b, the rows t of the fill with kind[t, b] > 0 are written, in
// time order, to output columns off[b] + j (j = their ordinal), for every
// field at once; columns from off[b] + (number kept) to W - 1 are zeroed;
// columns below off[b] are not touched (the accumulator of a merge); an
// optional init record goes to column 0.  Sources are read in the fill's
// (T, F, B) chain-minor layout (element (t, f, b) at t * row_stride +
// f * field_stride + b), so no transposing copy precedes the kernel; the
// output is the (B, W, F) skeleton layout.  A null source stands for rows
// of ones (the activity mask of a non-sticky fill).
//
// Design.  A CTA walks its chain's T rows in tiles of 256: a cub::BlockScan
// of the keep flags gives each kept row its output column, the kept rows'
// indices are staged in shared memory, and the block copies them field by
// field with consecutive threads on consecutive output elements, so the
// stores coalesce.  Pallas needed the log-shift form only because Mosaic
// cannot lower a sublane gather; here a row copy is direct.
//
// What bounds it on an H100: device-memory bytes.  The output stores are
// coalesced, but a chain's source elements sit B apart in the chain-minor
// fill, so every 4- or 8-byte load pulls a 32-byte sector that the CTAs of
// neighbouring chains read again (from L2, if they run close in time).  The
// next step is one CTA per 8-32 chains reading whole sectors.

#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXF = 12;

struct Field {
  const char* src;     // null: every source element is 1
  long row_stride;     // elements between rows t and t + 1
  long field_stride;   // elements between columns f and f + 1 of a row
  int width;           // F
  int elem;            // bytes per element: 1, 4 or 8
  const char* init;    // (B, F) record for column 0, or null
  char* out;           // (B, W, F)
};

struct Fields {
  Field f[MAXF];
  int n;
};

__device__ __forceinline__ void copy_elem(char* dst, const char* src, int elem) {
  if (elem == 8)
    *(uint64_t*)dst = src ? *(const uint64_t*)src : 1ull;
  else if (elem == 4)
    *(uint32_t*)dst = src ? *(const uint32_t*)src : 1u;
  else
    *(uint8_t*)dst = src ? *(const uint8_t*)src : (uint8_t)1;
}

__device__ __forceinline__ void zero_elem(char* dst, int elem) {
  if (elem == 8)
    *(uint64_t*)dst = 0ull;
  else if (elem == 4)
    *(uint32_t*)dst = 0u;
  else
    *(uint8_t*)dst = 0;
}

__global__ void compact_rows_kernel(const int* __restrict__ kind, long kind_row_stride,
                                    int T, int B, const int* __restrict__ off, int W,
                                    Fields fs) {
  using Scan = cub::BlockScan<int, THREADS>;
  __shared__ typename Scan::TempStorage scan_tmp;
  __shared__ int kept_rows[THREADS];
  const long b = blockIdx.x;
  const int tid = threadIdx.x;
  const long o = off ? off[b] : 0;
  long base = 0;  // rows kept so far

  for (int t0 = 0; t0 < T; t0 += THREADS) {
    const int t = t0 + tid;
    const int keep = (t < T && kind[(long)t * kind_row_stride + b] > 0) ? 1 : 0;
    int rank, n_tile;
    Scan(scan_tmp).ExclusiveSum(keep, rank, n_tile);
    if (keep) kept_rows[rank] = t;
    __syncthreads();
    for (int q = 0; q < fs.n; ++q) {
      const Field& f = fs.f[q];
      const long total = (long)n_tile * f.width;
      for (long e = tid; e < total; e += THREADS) {
        const int r = (int)(e / f.width), j = (int)(e - (long)r * f.width);
        const long col = o + base + r;
        if (col >= W) continue;
        const long src_idx = (long)kept_rows[r] * f.row_stride + j * f.field_stride + b;
        const long dst_idx = (b * W + col) * f.width + j;
        copy_elem(f.out + dst_idx * f.elem, f.src ? f.src + src_idx * f.elem : nullptr,
                  f.elem);
      }
    }
    base += n_tile;
    __syncthreads();  // kept_rows and scan_tmp are reused by the next tile
  }

  // zero the columns past the chain's events, then the init record
  const long start = o + base;
  for (int q = 0; q < fs.n; ++q) {
    const Field& f = fs.f[q];
    if (start < W) {
      const long total = (W - start) * f.width;
      for (long e = tid; e < total; e += THREADS)
        zero_elem(f.out + ((b * W + start) * f.width + e) * f.elem, f.elem);
    }
  }
  __syncthreads();
  for (int q = 0; q < fs.n; ++q) {
    const Field& f = fs.f[q];
    if (!f.init || W < 1) continue;
    for (int j = tid; j < f.width; j += THREADS)
      copy_elem(f.out + (b * W * f.width + j) * f.elem,
                f.init + (b * f.width + j) * f.elem, f.elem);
  }
}

}  // namespace

extern "C" int compact_rows_launch(const void* kind, long kind_row_stride, int T, int B,
                                   const void* off, int W, int n_fields,
                                   const void* const* srcs, const long* row_strides,
                                   const long* field_strides, const int* widths,
                                   const int* elems, const void* const* inits,
                                   void* const* outs, void* stream) {
  if (n_fields < 1 || n_fields > MAXF || B < 1 || T < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  Fields fs;
  fs.n = n_fields;
  for (int q = 0; q < n_fields; ++q) {
    if (elems[q] != 1 && elems[q] != 4 && elems[q] != 8) return (int)cudaErrorInvalidValue;
    fs.f[q] = Field{(const char*)srcs[q], row_strides[q], field_strides[q], widths[q],
                    elems[q], (const char*)inits[q], (char*)outs[q]};
  }
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  compact_rows_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)kind, kind_row_stride, T, B, (const int*)off, W, fs);
  return (int)cudaGetLastError();
}
